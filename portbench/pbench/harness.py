"""One run of one cell: build, warm up, measure for ``seconds``, read the
metrics, free the program, check its answers against the plain
reference, and return the result line.

The pieces are found by name (``loader.Benchmark``): the cell's
configuration names its system adapter (``systems/<system>.py``), the
cell names its traffic mix (``traffic/<mix>.json``) and its limits
(``limits/<cell>.json``), and each metric is read by
``e2e/<name>.py`` or ``metrics/<name>.py``.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from pathlib import Path

from pbench import traffic
from pbench.loader import Benchmark
from pbench.trace import Tracer

# modules no process that prints a result may hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class Run:
    """What the metric readers see of one run."""

    def __init__(self, bench, cell, config, mix, system, seed, seconds, setup_s):
        self.bench, self.cell, self.config, self.mix = bench, cell, config, mix
        self.system = system
        self.seed, self.seconds, self.setup_s = seed, seconds, setup_s
        self.recs: list[traffic.Rec] = []
        self.window = (math.nan, math.nan)  # host clock, perf_counter
        self.counters_before: dict = {}
        self.counters_after: dict = {}
        self.trace = None

    def completed(self) -> list[traffic.Rec]:
        """Requests answered inside the window."""
        return [r for r in self.recs if r.ok and r.t_done <= self.window[1]]

    def answered(self) -> list[traffic.Rec]:
        """Every request answered, in the window or after it closed."""
        return [r for r in self.recs if r.ok]

    def due(self) -> list[traffic.Rec]:
        """The requests of the window: all sent (closed loop), all due
        inside it (open loop)."""
        return [r for r in self.recs if r.due is None or r.due < self.window[1]]


class _GcPauses:
    """The garbage collector's pauses while it is open (``gc.callbacks``)."""

    def __init__(self):
        self.count, self.longest, self.total, self._t = 0, 0.0, 0.0, 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            d = time.perf_counter() - self._t
            self.count += 1
            self.total += d
            self.longest = max(self.longest, d)

    def close(self) -> None:
        gc.callbacks.remove(self._on)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sample(run: Run, n: int) -> list[traffic.Rec]:
    """Up to ``n`` of the answers given inside the window, drawn from the
    seed, in request order."""
    done = run.completed()
    if not done:
        return []
    pick = traffic.rng(run.seed, traffic.STREAM_SAMPLE).choice(len(done), size=min(n, len(done)),
                                                                replace=False)
    return [done[i] for i in sorted(pick)]


def _read(bench: Benchmark, run: Run, kind: str) -> dict:
    out = {}
    for m in bench.metrics(run.cell["name"], kind):
        value = bench.reader(m, kind).read(run)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_process: float, control: bool = False, log=sys.stderr) -> dict:
    """Run ``workload`` once and return its result line (a dict)."""
    t_enter = time.perf_counter()
    import torch

    bench = Benchmark(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    check_spec = bench.limits(workload)
    limits = check_spec["limits"]
    tracer = Tracer(trace, device)
    system = bench.system(config["system"]).System(
        config=config, mix=mix, seed=seed, device=device, tracer=tracer, control=control
    )
    system.setup()
    # what set-up made lives for the whole run: keep the collector from
    # walking it again in every full collection inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process
    print(f"set-up {setup_s:.3f} s: {t_enter - t_process:.3f} s to the harness (interpreter, torch, "
          f"the card's driver), {setup_s - (t_enter - t_process):.3f} s building the system and "
          "warming it up", file=log)
    run = Run(bench, cell, config, mix, system, seed, seconds, setup_s)
    schedule = traffic.Schedule(mix, seed, seconds)
    run.counters_before = system.counters()
    pauses = _GcPauses()
    tracer.start()
    t0 = time.perf_counter()
    run.window = (t0, t0 + seconds)
    if schedule.loop == "closed":
        run.recs = traffic.closed_loop(schedule, system.issue, system.is_rejection, t0, t0 + seconds)
    else:
        run.recs = traffic.open_loop(schedule, system.issue, system.is_rejection, t0)
        print(f"sender ran late by at most {traffic.lateness_s(run.recs) * 1e3:.3f} ms", file=log)
    run.trace = tracer.stop()
    pauses.close()
    print(f"collector: {pauses.count} collections in the window, longest {pauses.longest * 1e3:.3f} ms, "
          f"all {pauses.total * 1e3:.3f} ms", file=log)
    run.counters_after = system.counters()
    memory_peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    kind = "per_layer" if trace else "end_to_end"
    metrics = _read(bench, run, kind)
    due = run.due()
    failed = sum(1 for r in due if not r.ok)
    system.release()
    gc.unfreeze()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    sample = _sample(run, int(check_spec["sample"]))
    numbers = system.check(sample, run)
    # a request that was accepted and never answered, or answered with an
    # error, is lost; one refused at the door is a miss in the tail
    numbers["lost"] = sum(1 for r in due if r.error is not None and not r.rejected)
    checks = {name: {"value": float(v), "limit": float(limits[name])} for name, v in numbers.items()}
    print(f"compared {len(sample)} answers with the reference", file=log)
    correct = bool(sample) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()
    )
    result = {
        "correct": correct,
        "attempted": len(due),
        "failed": failed,
        "metrics": metrics,
        "device": _device(device, memory_peak, run.trace),
    }
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result


def _device(device: str, memory_peak: int, trace) -> dict:
    import torch

    if device.startswith("cuda"):
        kind, count = torch.cuda.get_device_name(0), 1
    else:
        kind, count = "cpu", 1
    out = {"platform": "gpu" if device.startswith("cuda") else "cpu", "kind": kind,
           "count": count, "memory_peak_bytes": int(memory_peak)}
    if trace is not None:
        out["busy_s"] = trace.busy_s()
        out["window_s"] = trace.window_s
    return out


def describe_checks(checks: dict) -> list[str]:
    """One line per number compared: its name, its value, its limit."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
