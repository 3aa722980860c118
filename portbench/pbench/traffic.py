"""The one traffic generator and the two loops that offer its requests.

A traffic mix is a JSON file of parameters (``portbench/traffic/``):

``loop``
    ``"closed"``: ``clients`` requests are outstanding at all times; each
    completion sends the next, until the window closes.  ``"open"``:
    requests are sent at due times drawn from ``arrivals``, whether or not
    earlier ones have finished.
``arrivals`` (open loop)
    ``{"process": "poisson", "rate_per_s": r}``.  The gaps between
    arrivals are the ``n = round(r * seconds)`` quantiles
    ``-ln(1 - (i + 0.5) / n) / r`` of the exponential distribution, in an
    order drawn from the seed: every seed offers the same set of gaps, so
    seeds change the order of the work and not its amount.
``request``
    The fields of every request.  A field is a constant, or
    ``{"balanced": [v, ...]}``: each run of ``len(v)`` consecutive
    requests takes every value once, in an order drawn from the seed (a
    uniform draw with equal counts).

A request's data (its clips) is drawn by the system adapter from
:func:`request_seed` ``(seed, index)``, so the same seed gives the same
inputs and the reference can draw them again.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import time
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

# sub-streams of a run's seed
STREAM_FIELDS = 1
STREAM_ARRIVALS = 2
STREAM_SAMPLE = 3
STREAM_DATA = 4
STREAM_WEIGHTS = 5


def request_seed(seed: int, *path: int) -> int:
    """A 64-bit seed for one sub-stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, *[int(p) for p in path]])
    hi, lo = ss.generate_state(2, np.uint32)
    return (int(hi) << 32) | int(lo)


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(request_seed(seed, *path))


class Schedule:
    """The requests of one run of a mix, drawn from ``seed``."""

    def __init__(self, mix: dict, seed: int, seconds: float):
        self.mix = mix
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.loop = mix["loop"]
        if self.loop not in ("closed", "open"):
            raise ValueError(f"unknown loop {self.loop!r}")
        self.clients = int(mix.get("clients", 1))
        self._fields = dict(mix["request"])
        self.due: list[float] | None = None
        if self.loop == "open":
            self.due = self._arrivals(mix["arrivals"])

    def _arrivals(self, spec: dict) -> list[float]:
        if spec.get("process") != "poisson":
            raise ValueError(f"unknown arrival process {spec.get('process')!r}")
        rate = float(spec["rate_per_s"])
        n = max(1, round(rate * self.seconds))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
        gaps = rng(self.seed, STREAM_ARRIVALS).permutation(gaps)
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        return [float(t) for t in due if t < self.seconds]

    def request(self, i: int) -> dict:
        """The fields of request ``i``."""
        out = {}
        for j, (name, spec) in enumerate(sorted(self._fields.items())):
            if isinstance(spec, dict):
                if set(spec) != {"balanced"}:
                    raise ValueError(f"field {name!r}: unknown spec {spec!r}")
                vals = list(spec["balanced"])
                block, pos = divmod(int(i), len(vals))
                order = rng(self.seed, STREAM_FIELDS, j, block).permutation(len(vals))
                out[name] = vals[int(order[pos])]
            else:
                out[name] = spec
        return out


@dataclasses.dataclass(eq=False)
class Rec:
    """One request of a run, stamped on the host clock."""

    idx: int
    params: dict
    due: float | None = None  # open loop: absolute perf_counter time
    t_sent: float | None = None
    t_done: float | None = None
    result: Any = None
    error: BaseException | None = None
    rejected: bool = False

    @property
    def ok(self) -> bool:
        return self.t_done is not None and self.error is None and not self.rejected


Issue = Callable[[Rec], Future]


def _watch(rec: Rec, fut: Future, done_q: queue.SimpleQueue) -> None:
    def on_done(f: Future) -> None:
        rec.t_done = time.perf_counter()
        exc = f.exception()
        if exc is not None:
            rec.error = exc
        else:
            rec.result = f.result()
        done_q.put(rec)

    fut.add_done_callback(on_done)


def closed_loop(schedule: Schedule, issue: Issue, is_rejection, t0: float, t_end: float,
                result_timeout_s: float = 120.0) -> list[Rec]:
    """Keep ``schedule.clients`` requests outstanding from one thread,
    sending request i + 1 when one completes, until ``t_end``; then wait
    for those in flight."""
    done_q: queue.SimpleQueue = queue.SimpleQueue()
    recs: list[Rec] = []
    outstanding = 0

    def send() -> None:
        nonlocal outstanding
        rec = Rec(len(recs), schedule.request(len(recs)))
        recs.append(rec)
        rec.t_sent = time.perf_counter()
        try:
            fut = issue(rec)
        except Exception as exc:  # noqa: BLE001 — a refused request is a result
            rec.t_done = time.perf_counter()
            rec.error = exc
            rec.rejected = bool(is_rejection(exc))
            done_q.put(rec)
        else:
            _watch(rec, fut, done_q)
        outstanding += 1

    while outstanding < schedule.clients and time.perf_counter() < t_end:
        send()
    while outstanding:
        done_q.get(timeout=result_timeout_s)
        outstanding -= 1
        if time.perf_counter() < t_end:
            send()
    return recs


def open_loop(schedule: Schedule, issue: Issue, is_rejection, t0: float,
              result_timeout_s: float = 120.0) -> list[Rec]:
    """Send request i at ``t0 + due[i]`` from this thread; then wait for
    every one of them."""
    done_q: queue.SimpleQueue = queue.SimpleQueue()
    recs: list[Rec] = []
    sent = 0
    for i, due in enumerate(schedule.due):
        rec = Rec(i, schedule.request(i), due=t0 + due)
        recs.append(rec)
        wait = rec.due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec.t_sent = time.perf_counter()
        try:
            fut = issue(rec)
        except Exception as exc:  # noqa: BLE001 — a refused request is a result
            rec.t_done = time.perf_counter()
            rec.error = exc
            rec.rejected = bool(is_rejection(exc))
            continue
        _watch(rec, fut, done_q)
        sent += 1
    deadline = time.perf_counter() + result_timeout_s
    for _ in range(sent):
        done_q.get(timeout=max(deadline - time.perf_counter(), 0.001))
    return recs


def lateness_s(recs: list[Rec]) -> float:
    """How late the open loop's sender ran behind its schedule, at most."""
    lags = [r.t_sent - r.due for r in recs if r.due is not None and r.t_sent is not None]
    return max(lags) if lags else math.nan
