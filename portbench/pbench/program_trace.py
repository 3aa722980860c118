"""The program's own spans beside the device trace.

``ProgramTracer`` is the benchmark's ``Tracer`` with three additions: it
turns on ``repro_torch.tracing`` for the window, it notes the thread of
each benchmark span (``threading.get_ident``, as the program's spans do),
and it keeps every runtime call the profile holds: each device
operation's launch (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaMemcpyAsync``, ... with the same CUPTI correlation id), its thread
and its host time.  Program spans are stamped on ``perf_counter_ns``, the
benchmark's own clock; the first window marker's launch, stamped on both
clocks, moves them onto the profiler's.

``ProgramTrace`` then gives each device operation the innermost program
span open in its launching thread at its launch, else the benchmark span
open there (``generate``: the adapters draw inputs on the card), else
``none``; it labels each idle gap as ``Trace`` does and appends the
innermost program span open at the gap's middle in the thread of the
benchmark span that names it (``search_batch/serve.readback``; in any
thread where no benchmark span is open: ``none/sched.form``).  The
functions at the end turn a trace and counter snapshots into the
program-side numbers ``tools/attribute.py`` prints.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import itertools
import threading
import time

from pbench import stats
from pbench.trace import GAP_PRIORITY, MARKER, MARKER_CYCLES, Trace, Tracer, _Span

NONE = "none"
THREAD_MASK = 0xFFFFFFFF  # threads are compared by the low 32 bits of their ident
# spans stamped by ``record`` (ends in two threads): they hold no launch
RECORDED = ("sched.queue",)
# runtime calls that allocate or free device or pinned host memory
ALLOC_CALLS = ("Malloc", "Free", "HostAlloc", "HostRegister", "MemCreate", "MemMap")
# how an operation found its span: its launch's thread and host time, or
# (no launch record) its own start on the device, in any thread
BY_LAUNCH, BY_DEVICE_TIME = "launch", "device_time"


@dataclasses.dataclass
class ProgramTrace(Trace):
    """A ``Trace`` with the program's spans and each operation's launch,
    all in the profiler's nanoseconds."""

    # (name, span id, parent id, thread, start, end, attrs)
    program_spans: list[tuple] = dataclasses.field(default_factory=list)
    span_threads: list[int] = dataclasses.field(default_factory=list)  # one per ``spans`` entry
    device_corr: list[int] = dataclasses.field(default_factory=list)  # one per ``device`` entry
    launches: dict[int, tuple[int, int]] = dataclasses.field(default_factory=dict)  # corr -> (thread, t)
    runtime_calls: list[tuple] = dataclasses.field(default_factory=list)  # (name, thread, start, duration)

    def __post_init__(self):
        self._threads = None
        self._attr = None

    # -- spans by thread ---------------------------------------------------

    def _index(self):
        """Per thread: program spans and benchmark spans sorted by start."""
        if self._threads is None:
            prog: dict[int, list] = collections.defaultdict(list)
            bench: dict[int, list] = collections.defaultdict(list)
            for sp in self.program_spans:
                if sp[0] not in RECORDED:
                    prog[sp[3]].append(sp)
            for (name, s, e), tid in zip(self.spans, self.span_threads):
                bench[tid].append((name, s, e))
            for v in prog.values():
                v.sort(key=lambda sp: sp[4])
            for v in bench.values():
                v.sort(key=lambda sp: sp[1])
            self._by_id = {sp[1]: sp for sp in self.program_spans}
            self._starts = {tid: [sp[4] for sp in v] for tid, v in prog.items()}
            self._bstarts = {tid: [sp[1] for sp in v] for tid, v in bench.items()}
            # the latest end among a thread's spans begun up to each one
            self._bmaxend = {tid: list(itertools.accumulate((sp[2] for sp in v), max))
                             for tid, v in bench.items()}
            self._threads = (prog, bench)
        return self._threads

    def program_span_at(self, tid: int, t: int) -> tuple | None:
        """The innermost program span of thread ``tid`` open at ``t``."""
        prog, _ = self._index()
        spans = prog.get(tid)
        if not spans:
            return None
        i = bisect.bisect_right(self._starts[tid], t) - 1
        if i < 0:
            return None
        sp = spans[i]
        # spans of one thread nest: walk up from the latest one begun
        while sp is not None and not (sp[4] <= t < sp[5]):
            sp = self._by_id.get(sp[2])
        return sp

    def bench_span_at(self, tid: int, t: int, names=None) -> tuple | None:
        """The latest-begun benchmark span of ``tid`` open at ``t``
        (of ``names`` only, if given)."""
        _, bench = self._index()
        spans = bench.get(tid, [])
        maxend = self._bmaxend.get(tid, [])
        i = bisect.bisect_right(self._bstarts.get(tid, []), t) - 1
        while i >= 0 and maxend[i] > t:
            name, s, e = spans[i]
            if s <= t < e and (names is None or name in names):
                return spans[i]
            i -= 1
        return None

    def threads_matched(self) -> bool:
        """Whether every launching thread is one that recorded spans."""
        prog, bench = self._index()
        return {tid for tid, _ in self.launches.values()} <= set(prog) | set(bench)

    # -- attribution ---------------------------------------------------------

    def attribution(self) -> list[tuple[str, str, str]]:
        """Per device operation (in ``device`` order): the span it is
        given, its kind (``program``, ``benchmark`` or ``none``) and how it
        was found (``launch`` or ``device_time``)."""
        if self._attr is not None:
            return self._attr
        prog, bench = self._index()
        threads = set(prog) | set(bench)
        out = []
        corr = self.device_corr or [0] * len(self.device)
        for (_, start, _), c in zip(self.device, corr):
            launch = self.launches.get(c)
            if launch is not None:
                tids, t, how = [launch[0]], launch[1], BY_LAUNCH
            else:
                tids, t, how = sorted(threads), start, BY_DEVICE_TIME
            sp = self._innermost(tids, t)
            if sp is not None:
                out.append((sp[0], "program", how))
                continue
            opened = [b for b in (self.bench_span_at(tid, t) for tid in tids) if b is not None]
            b = max(opened, key=lambda b: b[1], default=None)
            out.append((b[0], "benchmark", how) if b else (NONE, NONE, how))
        self._attr = out
        return out

    def by_span(self) -> dict[tuple[str, str], float]:
        """Device seconds by (span, operation name)."""
        out: dict[tuple[str, str], float] = collections.defaultdict(float)
        for (name, _, d), (span, _, _) in zip(self.device, self.attribution()):
            out[(span, name)] += d / 1e9
        return dict(out)

    def shares(self) -> dict[str, float]:
        """Shares of the device time of the window's operations given to a
        program span, a benchmark span and none, and the share found by
        device time instead of by launch."""
        total = sum(d for _, _, d in self.device) or 1
        acc = collections.Counter()
        for (_, _, d), (_, kind, how) in zip(self.device, self.attribution()):
            acc[kind] += d
            if how == BY_DEVICE_TIME:
                acc[how] += d
        return {k: acc[k] / total for k in ("program", "benchmark", NONE, BY_DEVICE_TIME)}

    def longest_gaps(self, n: int | None = None) -> list[tuple[int, int]]:
        """The window's idle stretches, longest first (all if ``n`` is None)."""
        w0, w1 = self.window
        gaps, t = [], w0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return gaps[:n]

    def gap_label(self, t: int) -> str:
        """``Trace``'s label of an idle moment (the first benchmark span of
        ``GAP_PRIORITY`` open, else ``none``) followed by ``/<span>``: the
        innermost program span open then in that benchmark span's thread
        (in any thread, for ``none``), where there is one."""
        prog, bench = self._index()
        for label in GAP_PRIORITY:
            tids = [tid for tid in bench if self.bench_span_at(tid, t, (label,))][:1]
            if tids:
                break
        else:
            label, tids = NONE, list(prog)
        inner = self._innermost(tids, t)
        return label if inner is None else f"{label}/{inner[0]}"

    def idle_gaps(self, n: int = 10) -> list[list]:
        """``Trace.idle_gaps`` with each label from ``gap_label``."""
        return [[self.gap_label((a + b) // 2), (b - a) / 1e9] for a, b in self.longest_gaps(n)]

    def idle_by_label(self) -> dict[str, float]:
        """Idle seconds of the window by ``gap_label`` of each stretch."""
        out: dict[str, float] = collections.defaultdict(float)
        for a, b in self.longest_gaps():
            out[self.gap_label((a + b) // 2)] += (b - a) / 1e9
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def self_times(self) -> dict[str, float]:
        """Host seconds inside each program span name, less the time of
        its child spans (a stage's own work)."""
        child: dict[int, int] = collections.Counter()
        for sp in self.program_spans:
            if sp[2] is not None:
                child[sp[2]] += sp[5] - sp[4]
        out: dict[str, float] = collections.defaultdict(float)
        for sp in self.program_spans:
            if sp[0] not in RECORDED:
                out[sp[0]] += (sp[5] - sp[4] - child[sp[1]]) / 1e9
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def long_calls(self, n: int = 10) -> list[list]:
        """The ``n`` longest runtime calls that do not wait for the card
        (``waits_for_card``): name, the span its thread had open, host
        seconds, start in the window."""
        calls = [c for c in self.runtime_calls
                 if not waits_for_card(c[0]) and self.window[0] <= c[2] < self.window[1]]
        calls.sort(key=lambda c: -c[3])
        return [[name, self._span_of(tid, start), dur / 1e9, (start - self.window[0]) / 1e9]
                for name, tid, start, dur in calls[:n]]

    def waits_by_span(self) -> dict[str, float]:
        """Host seconds of the window spent in runtime calls that wait for
        the card (``waits_for_card``), by the span their thread had open."""
        out: dict[str, float] = collections.defaultdict(float)
        for name, tid, start, dur in self.runtime_calls:
            if waits_for_card(name) and self.window[0] <= start < self.window[1]:
                out[self._span_of(tid, start)] += dur / 1e9
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def _span_of(self, tid: int, t: int) -> str:
        sp = self._innermost([tid], t)
        if sp is not None:
            return sp[0]
        sp = self.bench_span_at(tid, t)
        return sp[0] if sp is not None else NONE

    def _innermost(self, tids, t: int) -> tuple | None:
        """The latest-begun program span open at ``t`` among ``tids``."""
        found = None
        for tid in tids:
            sp = self.program_span_at(tid, t)
            if sp is not None and (found is None or sp[4] > found[4]):
                found = sp
        return found

    def allocations(self) -> list[list]:
        """The window's allocation calls to the runtime (``cudaMalloc``,
        ``cudaFree``, ``cudaHostAlloc``, ...): name, the span its thread
        had open, its host seconds, and its start in the window."""
        return [[name, self._span_of(tid, start), dur / 1e9, (start - self.window[0]) / 1e9]
                for name, tid, start, dur in self.runtime_calls
                if any(k in name for k in ALLOC_CALLS) and self.window[0] <= start < self.window[1]]


def waits_for_card(call: str) -> bool:
    """Whether a runtime call can hold its thread until the card catches
    up: ``*Synchronize``, and ``*Memcpy*`` (a pageable copy waits for the
    stream)."""
    return "Synchronize" in call or "Memcpy" in call


# -- the tracer ---------------------------------------------------------------


class _ThreadSpan(_Span):
    __slots__ = ()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        with self.tracer._lock:
            self.tracer._spans.append((self.name, self.t0, t1, threading.get_ident()))


def _kineto_events(prof):
    """(name, on the device, start, duration, correlation id, thread) of
    every event a finished profile holds, runtime calls included."""
    from torch.autograd import DeviceType

    try:
        from torch.autograd.profiler_util import _rewrite_name
    except ImportError:
        def _rewrite_name(name, with_wildcard=False):
            return name
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "is_hidden_event") and e.is_hidden_event():
            continue
        if hasattr(e, "is_user_annotation") and e.is_user_annotation():
            continue
        # a runtime call's resource id is CUPTI's thread id: the low 32
        # bits of the launching thread's ``pthread_self``
        yield (_rewrite_name(e.name(), with_wildcard=True), e.device_type() == DeviceType.CUDA,
               int(e.start_ns()), int(e.duration_ns()), int(e.correlation_id()),
               int(e.device_resource_id()) & THREAD_MASK)


class ProgramTracer(Tracer):
    """``Tracer`` that also records the program's spans, the benchmark
    spans' threads and each operation's launch (see the module)."""

    def __init__(self, enabled: bool, device: str, program: bool = True):
        super().__init__(enabled, device)
        self.program = program
        self._stamps: list[tuple[int, int]] = []  # host ns around each marker's launch
        self.drift_ns = None  # the two clocks' drift over the window, by the second marker

    def _mark(self) -> int:
        """``Tracer._mark``, stamping the host clock after the launch too."""
        import torch

        torch.cuda.synchronize()
        h = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        self._stamps.append((h, time.perf_counter_ns()))
        return h

    def span(self, name: str):
        if not self._on:
            return super().span(name)
        return _ThreadSpan(self, name)

    def start(self) -> None:
        super().start()
        if self.enabled and self.program:
            from repro_torch import tracing

            tracing.start()

    def stop(self) -> ProgramTrace | None:
        if not self.enabled:
            return None
        program = []
        if self.program:
            from repro_torch import tracing

            program = tracing.stop()
        self._on = False
        with self._lock:
            spans, self._spans = self._spans, []
        if self.cuda:
            import torch

            # the end marker first: what follows is not the window's work
            self._mark()
            torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
        else:
            h1 = time.perf_counter_ns()
        bench = [s[:3] for s in spans]
        threads = [s[3] & THREAD_MASK for s in spans]
        program = [(n, i, p, tid & THREAD_MASK, a, b, at) for n, i, p, tid, a, b, at in program]
        if not self.cuda:
            return ProgramTrace(window=(self._h0, h1), device=[], spans=bench,
                                program_spans=program, span_threads=threads)
        device, corr, marks, launches, calls, ends = [], [], [], {}, [], {}
        for name, cuda, start, dur, cid, tid in _kineto_events(self._prof):
            if not cuda:
                if name.startswith("cu"):
                    calls.append((name, tid, start, dur))
                    if cid > 0:
                        launches[cid] = (tid, start)
                        ends[cid] = start + dur
            elif MARKER in name:
                marks.append((start, start + dur, cid))
            elif not name.startswith("ProfilerStep"):
                device.append((name, start, dur))
                corr.append(cid)
        self._prof = None
        if len(marks) != 2:
            raise RuntimeError(f"the trace holds {len(marks)} window markers, not 2")
        marks.sort()
        window = (marks[0][0], marks[1][1])
        # host clock -> profiler clock: each marker's launch call lies between
        # the host stamps taken around it, so the offset lies between (call
        # end - stamp after) and (call start - stamp before); take the middle
        offsets = [((launches[c][1] - before) + (ends[c] - after)) // 2
                   for (_, _, c), (before, after) in zip(marks, self._stamps[-2:]) if c in launches]
        shift = offsets[0] if len(offsets) == 2 else window[0] - self._h0
        self.drift_ns = offsets[1] - offsets[0] if len(offsets) == 2 else None
        return ProgramTrace(
            window=window, device=device, spans=[(n, a + shift, b + shift) for n, a, b in bench],
            program_spans=[(n, i, p, tid, a + shift, b + shift, at) for n, i, p, tid, a, b, at in program],
            span_threads=threads, device_corr=corr, launches=launches, runtime_calls=calls,
        )


# -- per-layer numbers ------------------------------------------------------------


def is_fft(name: str) -> bool:
    return "fft" in name.lower()


def is_stmul_kernel(name: str) -> bool:
    """B1 / B2 (``mac_c1_kernel``, ``mac_kernel``, ``mac_grouped_kernel``)
    and B3 (``topk_partial_kernel``, ``topk_merge_kernel``)."""
    return "mac_" in name and "kernel" in name or "topk_" in name and "_kernel" in name


def queue_wait_ms_mean(before: dict, after: dict) -> float | None:
    """The scheduler's mean queue wait over the window, from its
    cumulative ``queue_wait_ns`` and ``dequeued``."""
    if "dequeued" not in before or "dequeued" not in after:
        return None
    n = after["dequeued"] - before["dequeued"]
    return (after["queue_wait_ns"] - before["queue_wait_ns"]) / n / 1e6 if n else None


def queue_wait_ms_quantiles(trace: ProgramTrace, qs=(0.5, 0.95)) -> list[float] | None:
    """Quantiles of the requests' waits in the scheduler's queue that ended
    inside the window (``sched.queue`` spans)."""
    w0, w1 = trace.window
    waits = [(sp[5] - sp[4]) / 1e6 for sp in trace.program_spans
             if sp[0] == "sched.queue" and w0 <= sp[5] <= w1]
    return [stats.quantile(waits, q) for q in qs] if waits else None


def batch_host_ms_mean(trace: ProgramTrace) -> float | None:
    """Per ``sched.batch`` span inside the window: its duration less the
    batcher's waits for the card in it, namely its ``serve.readback``
    descendants and, outside them, its thread's runtime calls that wait
    (``waits_for_card``: in search, the pageable copy of each window
    chunk)."""
    w0, w1 = trace.window
    by_id = {sp[1]: sp for sp in trace.program_spans}

    def cycle(sp):
        """The ``sched.batch`` span above ``sp`` (itself included), or None
        where there is none or a ``serve.readback`` comes first."""
        while sp is not None and sp[0] not in ("sched.batch", "serve.readback"):
            sp = by_id.get(sp[2])
        return sp if sp is not None and sp[0] == "sched.batch" else None

    wait: dict[int, int] = collections.Counter()
    for sp in trace.program_spans:
        if sp[0] == "serve.readback":
            p = cycle(by_id.get(sp[2]))
            if p is not None:
                wait[p[1]] += sp[5] - sp[4]
    for name, tid, start, dur in trace.runtime_calls:
        if waits_for_card(name):
            p = cycle(trace.program_span_at(tid, start))
            if p is not None:
                wait[p[1]] += min(dur, p[5] - start)
    host = [sp[5] - sp[4] - wait[sp[1]] for sp in trace.program_spans
            if sp[0] == "sched.batch" and w0 <= sp[4] and sp[5] <= w1]
    return sum(host) / len(host) / 1e6 if host else None


def device_us_per_frame(trace: ProgramTrace, frames: int, keep) -> float | None:
    """Device time of the operations ``keep(span, op)`` accepts, per frame
    answered, in microseconds (None where none is accepted)."""
    t = sum(s for (span, op), s in trace.by_span().items() if keep(span, op))
    return t * 1e6 / frames if frames and t > 0 else None


def head_us_per_frame(trace: ProgramTrace, frames: int) -> float | None:
    return device_us_per_frame(trace, frames, lambda span, op: span == "classify.head")


def glue_us_per_frame(trace: ProgramTrace, frames: int) -> float | None:
    """Device time given to ``engine.*`` and ``stmul.*`` spans that is
    neither cuFFT nor B1 / B2 / B3, per frame answered."""
    def keep(span, op):
        return span.startswith(("engine.", "stmul.")) and not is_fft(op) and not is_stmul_kernel(op)

    return device_us_per_frame(trace, frames, keep)


REBUILD_KEYS = ("cufft_plans", "device_allocs", "alloc_retries", "grating_misses")


def rebuilds(before: dict, after: dict) -> float | None:
    """Work built again inside the window: new cuFFT plans cached, device
    allocations, allocation retries and grating-cache misses."""
    keys = [k for k in REBUILD_KEYS if k in before and k in after]
    if not keys:
        return None
    return float(sum(after[k] - before[k] for k in keys))


def top_pairs(trace: ProgramTrace, n: int = 20) -> list[list]:
    """The ``n`` largest (span, operation) pairs by device seconds."""
    ranked = sorted(trace.by_span().items(), key=lambda kv: -kv[1])[:n]
    return [[span, op[:120], s] for (span, op), s in ranked]
