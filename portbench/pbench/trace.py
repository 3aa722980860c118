"""The traced run: the benchmark's own host spans and the device's
activity, from one ``torch.profiler`` session over the measured window.

The device events are read from the profiler's raw kineto results, not
from ``prof.events()`` / ``key_averages()``, which build a tree of every
host op first at ~70 us an event.  The reader is a frozen copy of
``chip_smoke.py``'s ``_device_events``.  The session records device
activity only: recording every host op as well cost the search cells a
sixth of their rate.  The benchmark's host spans (``generate``,
``submit``, ``search_batch``, ``classify``, ...) are stamped on the host
clock in whichever thread runs them, and moved onto the profiler's clock
by a marker kernel (``torch.cuda._sleep``, ``spin_kernel``) launched right
after a synchronisation at each end of the window: the markers bound the
traced window, and the first one's start, against the host time of its
launch, gives the offset between the two clocks (a launch's latency, some
microseconds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

MARKER = "spin_kernel"
MARKER_CYCLES = 1000
# when host spans overlap, an idle gap is named by the first of these open
GAP_PRIORITY = ("search_batch", "classify", "classify_stream", "submit", "generate")


@dataclasses.dataclass
class Trace:
    """What one traced window held, in the profiler's nanoseconds."""

    window: tuple[int, int]
    device: list[tuple[str, int, int]]  # (name, start, duration)
    spans: list[tuple[str, int, int]]  # (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of device activity inside the window, merged."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(s + d, w1)) for _, s, d in self.device if s < w1 and s + d > w0)
        merged: list[list[int]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_time_s(self, match) -> float:
        """Summed device time of the events whose name ``match`` accepts."""
        return sum(d for n, _, d in self.device if match(n)) / 1e9

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, int] = {}
        for name, _, d in self.device:
            by[name] = by.get(name, 0) + d
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], d / 1e9] for name, d in ranked]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest idle stretches of the window, each named by
        the benchmark's host span open at its middle (``none`` if none)."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) // 2
            open_ = {name for name, s, e in self.spans if s <= mid < e}
            label = next((p for p in GAP_PRIORITY if p in open_), None)
            out.append([label or "none", (b - a) / 1e9])
        return out


def _raw_events(prof):
    """(name, on the device, start ns, duration ns) of every event a
    finished profile holds."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results
    try:
        from torch.autograd.profiler_util import _rewrite_name
    except ImportError:
        def _rewrite_name(name, with_wildcard=False):
            return name
    for e in raw.events():
        if hasattr(e, "is_hidden_event") and e.is_hidden_event():
            continue
        if hasattr(e, "is_user_annotation") and e.is_user_annotation():
            continue
        yield (_rewrite_name(e.name(), with_wildcard=True), e.device_type() == DeviceType.CUDA,
               int(e.start_ns()), int(e.duration_ns()))


class _Span:
    __slots__ = ("tracer", "name", "t0")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        with self.tracer._lock:
            self.tracer._spans.append((self.name, self.t0, t1))


class Tracer:
    """Host spans (no-ops while tracing is off) and, when on, one profiler
    session of the card's activity around the window.  On the CPU (the
    tests) there is no device to trace: the window is the host's."""

    def __init__(self, enabled: bool, device: str):
        self.enabled = bool(enabled)
        self.cuda = device.startswith("cuda")
        self._on = False
        self._prof = None
        self._lock = threading.Lock()
        self._spans: list[tuple[str, int, int]] = []  # guarded-by: _lock
        self._h0 = 0

    def span(self, name: str):
        if not self._on:
            return contextlib.nullcontext()
        return _Span(self, name)

    def _mark(self) -> int:
        """Synchronise, then launch a marker; the host time of its launch."""
        import torch

        torch.cuda.synchronize()
        h = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        return h

    def start(self) -> None:
        if not self.enabled:
            return
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._h0 = self._mark()
        else:
            self._h0 = time.perf_counter_ns()
        self._on = True

    def stop(self) -> Trace | None:
        if not self.enabled:
            return None
        self._on = False
        with self._lock:
            spans, self._spans = self._spans, []
        if not self.cuda:
            return Trace(window=(self._h0, time.perf_counter_ns()), device=[], spans=spans)
        import torch

        self._mark()
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        device, marks = [], []
        for name, cuda, start, dur in _raw_events(self._prof):
            if not cuda:
                continue
            if MARKER in name:
                marks.append((start, start + dur))
            elif not name.startswith("ProfilerStep"):
                device.append((name, start, dur))
        self._prof = None
        if len(marks) != 2:
            raise RuntimeError(f"the trace holds {len(marks)} window markers, not 2")
        marks.sort()
        window = (marks[0][0], marks[1][1])
        shift = window[0] - self._h0  # host clock -> profiler clock
        spans = [(n, a + shift, b + shift) for n, a, b in spans]
        return Trace(window=window, device=device, spans=spans)
