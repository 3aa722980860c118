"""Serving-resilience primitives: typed error taxonomy, deadline
watchdog, deterministic retry backoff, and the circuit-breaker
degradation ladder (the port's own copy of
``repro.launch.resilience``).

The serving stack (``launch/serve.py``) promises one invariant above
all others: **every submitted future resolves** — with a result or a
*typed* error — no hangs, ever.  This module supplies the pieces that
invariant is built from; none of them import the serving stack (or jax),
so they are reusable by any request/response layer:

* :class:`ServingError` hierarchy — every failure the serving stack can
  route into a future, each carrying the ``tenant`` and ``batch_id`` it
  happened in and chaining the root cause via ``__cause__``:
  :class:`RequestRejected` (admission control), :class:`DeadlineExceeded`
  (the request's deadline passed before a result was ready),
  :class:`TenantQuarantined` (signal-integrity guard isolated this
  tenant's rows from a pooled batch), :class:`BatchExecutionError`
  (a dispatch failed after retries were exhausted),
  :class:`SchedulerClosed` (shutdown resolved a queued request), and
  :class:`ReplicaUnavailable` (the replicated serving layer found no
  live replica to serve — or finish serving — the request).

* :class:`RetryPolicy` — decorrelated-jitter exponential backoff
  (`sleep = min(cap, U(base, 3*prev))`, the AWS recipe) with a *seeded*
  RNG: :meth:`RetryPolicy.delays` yields the same schedule every time it
  is called, so retry behavior is deterministic in tests.  Passing the
  request's absolute ``deadline`` truncates the schedule: no retry (or
  hedge) is ever scheduled past the remaining deadline budget.

* :class:`CircuitBreaker` / :class:`DegradationLadder` — per-execution-
  path breakers (closed → open on ``failure_threshold`` consecutive
  failures → half-open after ``recovery_s`` → closed on a successful
  probe) stacked into a ladder of serving modes
  (``pooled → sequential → single``): the scheduler serves from the
  highest rung whose breaker admits traffic, so a failing pooled path
  degrades to per-tenant-sequential dispatch instead of failing
  requests, and recovers automatically once the pooled path heals.
  The clock is injectable, so trip/recover transitions are
  deterministic in tests.

* :class:`Watchdog` — a daemon thread holding every in-flight
  ``(future, deadline)``; a future still unresolved at its deadline is
  resolved with :class:`DeadlineExceeded` *by the watchdog*, whatever
  the batcher is doing — the backstop that turns "should not hang" into
  "cannot hang".

Transient vs permanent failures: an exception with a truthy
``transient`` attribute (e.g. an injected chaos fault)
is retried under the :class:`RetryPolicy`; validation errors
(``ValueError`` / ``KeyError`` / ``TypeError``) are neither retried nor
counted against a breaker — a malformed request would fail every rung.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time
from concurrent.futures import Future
from typing import Callable, Iterator


# ---------------------------------------------------------------------------
# Typed error taxonomy
# ---------------------------------------------------------------------------


class ServingError(RuntimeError):
    """Base of every typed serving failure.

    Attributes:
      tenant: the tenant the failing request addressed (None when the
        failure is not attributable to one request).
      batch_id: the scheduler's id of the microbatch the request rode
        in (None outside the scheduler).
    """

    def __init__(
        self,
        message: str,
        *,
        tenant: str | None = None,
        batch_id: int | None = None,
    ):
        super().__init__(message)
        self.tenant = tenant
        self.batch_id = batch_id


class RequestRejected(ServingError):
    """Admission control shed this request (the bounded queue is full)."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before a result was ready."""


class TenantQuarantined(ServingError):
    """The signal-integrity guard isolated this tenant's rows (non-finite
    correlation scores) from an otherwise-healthy pooled batch."""


class BatchExecutionError(ServingError):
    """A dispatch failed after retries were exhausted; the root cause is
    chained via ``__cause__``."""


class SchedulerClosed(ServingError):
    """Scheduler shutdown resolved this still-queued request."""


class ReplicaUnavailable(ServingError):
    """No live replica could serve (or finish serving) this request.

    Raised by the replicated serving layer (``launch/replica.py``) when
    dispatch finds no healthy replica, or when a request's every
    failover attempt died with the replica that held it.  Infra-side
    and transient by nature — a *replica set* level failure, distinct
    from :class:`BatchExecutionError` (a dispatch that ran and failed).
    ``replica`` names the last replica tried, when attributable.
    """

    transient = True

    def __init__(
        self,
        message: str,
        *,
        tenant: str | None = None,
        batch_id: int | None = None,
        replica: str | None = None,
    ):
        super().__init__(message, tenant=tenant, batch_id=batch_id)
        self.replica = replica


def is_transient(exc: BaseException) -> bool:
    """Whether ``exc`` is worth retrying (a truthy ``transient`` attr)."""
    return bool(getattr(exc, "transient", False))


def is_validation_error(exc: BaseException) -> bool:
    """Caller errors that would fail identically on every rung/retry."""
    return isinstance(exc, (ValueError, KeyError, TypeError))


def resolve_result(future: Future, result) -> bool:
    """``future.set_result`` tolerant of lost races (the watchdog or a
    cancel may already have resolved it).  True = this call delivered."""
    try:
        future.set_result(result)
        return True
    except Exception:  # InvalidStateError / cancelled
        return False


def resolve_exception(future: Future, exc: BaseException) -> bool:
    """``future.set_exception`` tolerant of lost races (see
    :func:`resolve_result`)."""
    try:
        future.set_exception(exc)
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# Deterministic retry backoff
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Decorrelated-jitter exponential backoff with a seeded RNG.

    ``delays()`` yields ``max_retries`` sleep durations following
    ``d_{k} = min(cap_s, U(base_s, 3 * d_{k-1}))`` (AWS decorrelated
    jitter) from a *fresh* ``random.Random(seed)`` each call — the
    schedule is identical on every invocation, so tests can pin it.
    """

    max_retries: int = 3
    base_s: float = 0.001
    cap_s: float = 0.05
    seed: int = 0

    def delays(
        self,
        deadline: float | None = None,
        clock: Callable[[], float] = time.time,
    ) -> Iterator[float]:
        """The seeded backoff schedule, optionally truncated by a
        deadline.

        ``deadline`` is absolute in ``clock``'s frame (the scheduler
        passes the batch's earliest request deadline on ``time.time``).
        A delay that would complete at or past the deadline is **not**
        yielded and the schedule ends there: no retry — and by the same
        rule no hedge — may be scheduled past the request's remaining
        budget; burning the tail of the budget on a sleep guarantees a
        ``DeadlineExceeded`` that an immediate typed failure would have
        delivered sooner.  The jitter draws are consumed identically
        with or without a deadline, so the un-truncated prefix of the
        schedule is the same deterministic sequence tests pin.
        """
        rng = random.Random(self.seed)
        prev = self.base_s
        for _ in range(self.max_retries):
            prev = min(self.cap_s, rng.uniform(self.base_s, 3.0 * prev))
            if deadline is not None and clock() + prev >= deadline:
                return
            yield prev


# ---------------------------------------------------------------------------
# Circuit breaker + degradation ladder
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Per-execution-path circuit breaker.

    closed → (``failure_threshold`` consecutive breaker-worthy failures)
    → open → (``recovery_s`` elapsed) → half-open → closed on a
    successful probe / back to open on a failed one.  ``clock`` is
    injectable (default ``time.monotonic``) so the open → half-open
    transition is deterministic in tests.  Thread-safe.
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        recovery_s: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.recovery_s = float(recovery_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"  # guarded-by: _lock
        self._consecutive = 0  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        self.failures = 0  # guarded-by: _lock
        self.successes = 0  # guarded-by: _lock
        self.trips = 0  # closed/half-open -> open; guarded-by: _lock
        self.recoveries = 0  # half-open -> closed; guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """Whether this path may serve the next dispatch.  An open
        breaker past its recovery window transitions to half-open here
        and admits the probe."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.recovery_s:
                    self._state = "half_open"
                else:
                    return False
            return True  # half-open: admit the probe

    def record_success(self) -> None:
        with self._lock:
            self.successes += 1
            self._consecutive = 0
            if self._state == "half_open":
                self._state = "closed"
                self.recoveries += 1

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self._consecutive += 1
            if self._state == "half_open" or (
                self._state == "closed"
                and self._consecutive >= self.failure_threshold
            ):
                self._state = "open"
                self._opened_at = self._clock()
                self._consecutive = 0
                self.trips += 1

    def trip(self) -> None:
        """Force the breaker open (benchmarks: measure the degraded
        rung without manufacturing real failures)."""
        with self._lock:
            if self._state != "open":
                self._state = "open"
                self.trips += 1
            self._opened_at = self._clock()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "failures": self.failures,
                "successes": self.successes,
                "trips": self.trips,
                "recoveries": self.recoveries,
                "consecutive_failures": self._consecutive,
            }


class DegradationLadder:
    """Ordered serving modes, each (but the last) behind its own breaker.

    ``select()`` returns the highest rung whose breaker admits traffic —
    the mode the next dispatch should run in; the caller reports the
    outcome back via ``report(mode, ok)``.  The last rung has no breaker:
    there is always *some* mode to serve in (requests fail individually
    there, never for lack of a path).  ``peek()`` is the side-effect-free
    view for metrics (no open → half-open transition).
    """

    def __init__(
        self,
        modes: tuple[str, ...] = ("pooled", "sequential", "single"),
        failure_threshold: int = 3,
        recovery_s: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ):
        if len(modes) < 1:
            raise ValueError("need at least one serving mode")
        self.modes = tuple(modes)
        self.breakers = {
            m: CircuitBreaker(failure_threshold, recovery_s, clock)
            for m in self.modes[:-1]
        }

    def select(self) -> str:
        for mode in self.modes[:-1]:
            if self.breakers[mode].allow():
                return mode
        return self.modes[-1]

    def peek(self) -> str:
        """Current mode without mutating breaker state (metrics)."""
        for mode in self.modes[:-1]:
            if self.breakers[mode].state != "open":
                return mode
        return self.modes[-1]

    def report(self, mode: str, ok: bool) -> None:
        brk = self.breakers.get(mode)
        if brk is None:  # the last rung has no breaker
            return
        if ok:
            brk.record_success()
        else:
            brk.record_failure()

    def metrics(self) -> dict:
        return {
            "mode": self.peek(),
            "breakers": {m: b.snapshot() for m, b in self.breakers.items()},
        }


# ---------------------------------------------------------------------------
# Deadline watchdog
# ---------------------------------------------------------------------------


class Watchdog:
    """Daemon thread guaranteeing deadline resolution of tracked futures.

    ``track(future, deadline, tenant=...)`` registers an in-flight
    request; any tracked future still unresolved at its deadline is
    resolved with :class:`DeadlineExceeded` by the watchdog thread —
    whatever the executor is doing at the time.  ``on_tick`` (optional)
    runs once per scan, for owner-side liveness checks (e.g. "is the
    batcher thread still alive?").  Done futures are swept from the
    registry each scan, so tracking is O(in-flight).
    """

    def __init__(
        self,
        interval_s: float = 0.02,
        clock: Callable[[], float] = time.time,
        on_expire: Callable[[str | None], None] | None = None,
        on_tick: Callable[[], None] | None = None,
    ):
        self.interval_s = float(interval_s)
        self._clock = clock
        self._on_expire = on_expire
        self._on_tick = on_tick
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._tracked: dict[int, tuple[Future, float, str | None]] = {}  # guarded-by: _lock
        self.expired = 0  # guarded-by: _lock
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="serving-watchdog", daemon=True
        )
        self._thread.start()

    def track(
        self, future: Future, deadline: float | None, tenant: str | None = None
    ) -> None:
        """Register a future; ``deadline`` is absolute (same clock as
        ``clock``).  None = no deadline (still swept when done)."""
        if deadline is None:
            return  # nothing for the watchdog to enforce
        with self._lock:
            self._tracked[next(self._seq)] = (future, float(deadline), tenant)

    def sweep(self) -> int:
        """One scan: expire overdue futures, drop resolved ones.
        Returns the number expired in this scan (also callable from
        tests for a deterministic tick)."""
        now = self._clock()
        expired: list[tuple[Future, float, str | None]] = []
        with self._lock:
            done = [k for k, (f, _, _) in self._tracked.items() if f.done()]
            for k in done:
                del self._tracked[k]
            due = [
                k
                for k, (_, dl, _) in self._tracked.items()
                if now >= dl
            ]
            for k in due:
                expired.append(self._tracked.pop(k))
        n = 0
        for future, deadline, tenant in expired:
            err = DeadlineExceeded(
                f"deadline exceeded ({now - deadline:.3f}s overdue)"
                + (f" for tenant {tenant!r}" if tenant else ""),
                tenant=tenant,
            )
            if resolve_exception(future, err):
                n += 1
        if n:
            with self._lock:
                self.expired += n
            if self._on_expire is not None:
                for future, _, tenant in expired:
                    self._on_expire(tenant)
        return n

    def _run(self) -> None:
        while not self._closed.wait(self.interval_s):
            try:
                self.sweep()
                if self._on_tick is not None:
                    self._on_tick()
            except Exception:  # noqa: BLE001 — the watchdog must survive
                pass

    @property
    def tracked(self) -> int:
        with self._lock:
            return len(self._tracked)

    def close(self) -> None:
        self._closed.set()
        self._thread.join(timeout=5.0)
