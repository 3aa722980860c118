"""In-memory spans at the layer boundaries of the serving path.

``span(name)`` marks one stage (``sched.batch``, ``serve.fetch``,
``engine.chunk``, ``stmul.irfftn``, ``classify.head``, ...) as a context
manager.  Recording is off by default: then ``span`` makes one check of a
module flag and returns the same shared no-op object every time, so a
span on the hot path costs a function call and allocates nothing.
``start()`` clears the record and turns recording on; ``stop()`` turns it
off and returns what was recorded.  Only a profiling harness calls them.

A recorded span is the tuple ``(name, span_id, parent_id, thread_id,
t0_ns, t1_ns, attrs)``: ``thread_id`` is ``threading.get_ident()`` of the
thread that ran it (the thread id CUPTI gives a launch, and no system
call, where ``get_native_id`` is one), ``parent_id`` the innermost span open in that thread when it
began (``None`` at the top), the times ``time.perf_counter_ns()``, and
``attrs`` a dict (the scheduler's ``batch`` id, a request number) or
``None``.  ``record()`` adds a span whose two ends were stamped by
different threads (a request's wait in the scheduler's queue).

``runtime_counters(device)`` snapshots torch's own cumulative counters of
work that is built again rather than reused: cuFFT plans cached, the
caching allocator's device allocations and its retries after a failed
allocation.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

_on = False
_lock = threading.Lock()
_spans: list[tuple] = []  # guarded-by: _lock
_ids = itertools.count(1)
_local = threading.local()


class _NoSpan:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def note(self, key: str, value) -> None:
        return None


NO_SPAN = _NoSpan()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "sid", "parent", "attrs", "t0")

    def __init__(self, name: str):
        self.name, self.attrs = name, None

    def __enter__(self) -> "_Span":
        st = _stack()
        self.parent = st[-1].sid if st else None
        self.sid = next(_ids)
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _append((self.name, self.sid, self.parent, threading.get_ident(), self.t0, t1,
                 self.attrs))

    def note(self, key: str, value) -> None:
        """Attach one attribute to the open span (a batch id known only
        once the batch is formed)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value


def _append(rec: tuple) -> None:
    # a span still open when stop() ran is dropped, not left behind
    with _lock:
        if _on:
            _spans.append(rec)


def span(name: str):
    """A context manager around one stage; ``note`` tags the open span."""
    if not _on:
        return NO_SPAN
    return _Span(name)


def record(name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
    """Add a span whose ends were stamped apart (``perf_counter_ns``),
    outside the thread's nesting."""
    if _on:
        _append((name, next(_ids), None, threading.get_ident(), int(t0_ns), int(t1_ns),
                 attrs or None))


def recording() -> bool:
    """Whether spans are being recorded (to skip building a span's
    attributes while they are not)."""
    return _on


def start() -> None:
    """Clear the record and turn recording on."""
    global _on, _spans
    with _lock:
        _spans = []
        _on = True


def stop() -> list[tuple]:
    """Turn recording off and return the spans recorded since ``start``."""
    global _on, _spans
    with _lock:
        _on = False
        out, _spans = _spans, []
    return out


def runtime_counters(device) -> dict:
    """torch's cumulative counters of rebuilt work on ``device``: the
    cuFFT plan cache's size, the caching allocator's device allocations
    (``cudaMalloc`` calls) and allocation retries.  Empty off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stats = torch.cuda.memory_stats(index)
    return {
        "cufft_plans": int(torch.backends.cuda.cufft_plan_cache[index].size),
        "device_allocs": int(stats.get("num_device_alloc", stats.get("segment.all.allocated", 0))),
        "alloc_retries": int(stats.get("num_alloc_retries", 0)),
    }
