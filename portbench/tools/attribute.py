"""Trace one cell with the program's spans on, and give the card's time to
the program's stages.

    python3 portbench/tools/attribute.py --workload search-saturated \\
        --seeds 11,12,13 --seconds 30 --spans 1 --out attribute.json

Each seed is one traced run of the cell as ``run.py --trace 1`` makes it
(set-up, warm-up, the measured window under the profiler), with
``pbench.program_trace.ProgramTracer`` in place of the benchmark's tracer.
It prints one JSON row per seed: frames answered per second of the traced
window, the cell's per-layer metrics, the program-side numbers
(``queue_wait_ms.mean``, ``batch_host_ms.mean``, ``head_us_per_frame``,
``glue_us_per_frame``, ``rebuilds``), the shares of device time given to a
program span, a benchmark span and none, the 20 largest (span, device
operation) pairs, the ten longest idle gaps with the program span open
in them, idle seconds, host seconds and host waits for the card by span, the window's allocation calls and
longest runtime calls with their spans, and the collector's pauses.  ``--spans 0`` keeps the program's recorder off under the same
profile (the recorder's cost), and runs on a checkout whose program has
no recorder.  ``--device cpu`` rehearses it on the host (no device trace).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]


def program_counters(system, device: str) -> dict:
    """The program's cumulative counters the program-side numbers read:
    the scheduler's queue wait, the grating cache's misses, torch's
    rebuilt work.  Keys the program lacks are left out."""
    from repro_torch.core.engine import default_cache

    out = {}
    sched = getattr(system, "sched", None)
    if sched is not None:
        m = sched.metrics()
        out.update({k: m[k] for k in ("dequeued", "queue_wait_ns") if k in m})
    cache = getattr(system.server, "cache", None) or default_cache()
    out["grating_misses"] = cache.stats()["misses"]
    try:
        from repro_torch.tracing import runtime_counters
    except ImportError:
        return out
    out.update(runtime_counters(device))
    return out


def _gc_log():
    """``harness._GcPauses`` that also keeps (start, seconds) of each
    collection, to set beside the window's idle gaps."""
    from pbench import harness

    class GcLog(harness._GcPauses):
        def __init__(self):
            self.log = []
            super().__init__()

        def _on(self, phase: str, info: dict) -> None:
            super()._on(phase, info)
            if phase != "start":
                self.log.append((self._t, time.perf_counter() - self._t))

    return GcLog()


def run_once(root: Path, workload: str, seed: int, seconds: float, device: str, spans: bool,
             t_process: float) -> dict:
    """``harness.run_cell``'s traced run, step for step up to the window's
    end, with ``ProgramTracer`` in the benchmark tracer's place; it reads
    the program-side numbers where ``run_cell`` checks the answers."""
    import torch

    from pbench import harness, program_trace as pt, traffic
    from pbench.loader import Benchmark

    bench = Benchmark(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    tracer = pt.ProgramTracer(True, device, program=spans)
    system = bench.system(config["system"]).System(config=config, mix=mix, seed=seed, device=device,
                                                   tracer=tracer, control=False)
    system.setup()
    gc.collect()
    gc.freeze()
    run = harness.Run(bench, cell, config, mix, system, seed, seconds, time.perf_counter() - t_process)
    schedule = traffic.Schedule(mix, seed, seconds)
    run.counters_before = system.counters()
    before = program_counters(system, device)
    pauses = _gc_log()
    tracer.start()
    t0 = time.perf_counter()
    run.window = (t0, t0 + seconds)
    if schedule.loop == "closed":
        run.recs = traffic.closed_loop(schedule, system.issue, system.is_rejection, t0, t0 + seconds)
    else:
        run.recs = traffic.open_loop(schedule, system.issue, system.is_rejection, t0)
    trace = run.trace = tracer.stop()
    pauses.close()
    gc_pauses = {"count": pauses.count, "longest_s": pauses.longest,
                 "over_5ms": [[t - t0, d] for t, d in pauses.log if d > 5e-3]}
    after = program_counters(system, device)
    run.counters_after = system.counters()
    metrics = harness._read(bench, run, "per_layer")
    frames = sum(system.frames(r) for r in run.answered())
    row = {
        "workload": workload, "seed": seed, "spans": spans, "device": device,
        "frames_per_s": harness._read(bench, run, "end_to_end").get("frames_per_s", {}).get("value"),
        "metrics": {k: v["value"] for k, v in metrics.items()},
        "program": {
            "queue_wait_ms.mean": pt.queue_wait_ms_mean(before, after),
            "queue_wait_ms.p50_p95": pt.queue_wait_ms_quantiles(trace),
            "batch_host_ms.mean": pt.batch_host_ms_mean(trace),
            "head_us_per_frame": pt.head_us_per_frame(trace, frames),
            "glue_us_per_frame": pt.glue_us_per_frame(trace, frames),
            "rebuilds": pt.rebuilds(before, after),
        },
        "counters": {"before": before, "after": after},
        "window_s": trace.window_s,
        "busy_s": trace.busy_s(),
        "device_ops": len(trace.device),
        "launches_matched": sum(1 for c in trace.device_corr if c in trace.launches),
        "threads_matched": trace.threads_matched(),
        "clock_drift_ns": tracer.drift_ns,
        "shares": trace.shares(),
        "top_pairs": pt.top_pairs(trace, 20),
        "idle_gaps": trace.idle_gaps(10),
        "idle_gap_starts_s": [(a - trace.window[0]) / 1e9 for a, _ in trace.longest_gaps(10)],
        "idle_by_label": dict(list(trace.idle_by_label().items())[:15]),
        "host_self_s": dict(list(trace.self_times().items())[:20]),
        "host_waits_s": dict(list(trace.waits_by_span().items())[:10]),
        "allocations": trace.allocations(),
        "long_calls": trace.long_calls(10),
        "gc_pauses": gc_pauses,
        "program_spans": dict(collections.Counter(sp[0] for sp in trace.program_spans)),
    }
    system.release()
    gc.unfreeze()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = T_PROCESS if not rows else time.perf_counter()
        row = run_once(ROOT, args.workload, seed, args.seconds, args.device, bool(args.spans), t)
        rows.append(row)
        print(json.dumps(row), flush=True)
        for span, op, s in row["top_pairs"]:
            print(f"{args.workload} seed {seed}: {s:10.6f} s  {span:<24} {op}", file=sys.stderr)
        print(f"{args.workload} seed {seed}: shares {row['shares']}", file=sys.stderr)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
