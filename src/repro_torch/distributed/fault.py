"""Chaos injection for the serving seams (the port's own copy of the
chaos part of ``repro.distributed.fault``).

The serving stack calls ``injector.on(seam, ...)`` at its named seams —
``cache_fetch``, ``encode``, ``dispatch``, ``readout`` — and rules
decide, deterministically from a seeded RNG, whether to raise a
transient :class:`InjectedFault`, sleep a latency spike, poison a payload
row with NaNs, or run an arbitrary action (e.g. racing an eviction).  A
server with no injector attached pays a single attribute check.

The draws are the reference's: the same rules and seed fire at the same
events and poison the same rows in both packages.  The restart loop
(``run_with_restarts``), ``FailureInjector``, heartbeat membership and
shard reassignment are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time
from typing import Callable

import numpy as np


class SimulatedFailure(RuntimeError):
    """Raised by failure injection to emulate a node crash."""


class InjectedFault(SimulatedFailure):
    """A chaos-injected serving fault.  ``transient = True`` marks it
    retryable to the serving retry policy (resilience.is_transient)."""

    transient = True

    def __init__(self, seam: str, detail: str = ""):
        super().__init__(
            f"injected fault at seam {seam!r}" + (f": {detail}" if detail else "")
        )
        self.seam = seam


@dataclasses.dataclass(frozen=True)
class ChaosRule:
    """One injection rule.

    Fields:
      seam: seam name this rule listens on (``cache_fetch``, ``encode``,
        ``dispatch``, ``readout``, or anything a caller invents).
      kind: ``raise`` (throw :class:`InjectedFault`), ``latency``
        (sleep ``delay_s``), ``nan`` (poison one row of an ndarray
        payload), or ``call`` (run ``action``).
      rate: probability per matching event, drawn from the injector's
        seeded RNG (0 disables stochastic firing).
      at: event indices (1-based per seam, or the caller-supplied
        ``event`` id) at which the rule fires deterministically, once
        per index.
      mode: only fire when the seam event's ``mode`` matches (None =
        any), e.g. restrict a dispatch fault to the pooled path.
      delay_s: sleep duration for ``latency`` rules.
      action: callable for ``call`` rules.
    """

    seam: str
    kind: str
    rate: float = 0.0
    at: tuple[int, ...] = ()
    mode: str | None = None
    delay_s: float = 0.0
    action: Callable[[], None] | None = None

    def __post_init__(self):
        if self.kind not in ("raise", "latency", "nan", "call"):
            raise ValueError(f"unknown chaos kind {self.kind!r}")


class ChaosInjector:
    """Deterministic, seeded chaos for the serving seams.

    ``on(seam, mode=..., payload=..., event=...)`` is called by the
    instrumented code at each seam; every matching rule evaluates
    (deterministic ``at`` indices first, then the seeded stochastic
    ``rate``) and its effect is applied.  ``nan`` rules transform and
    return the payload; the caller must use the return value.  Rules are
    mutable at runtime (``injector.rules``) so a storm can be switched
    off mid-run to exercise breaker recovery.  Thread-safe; per-seam
    event and per-(seam, kind) injection counters in ``stats()``.
    """

    def __init__(self, rules: tuple[ChaosRule, ...] | list[ChaosRule] = (), seed: int = 0):
        self.rules: list[ChaosRule] = list(rules)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._events: collections.Counter = collections.Counter()  # guarded-by: _lock
        self._injected: collections.Counter = collections.Counter()  # guarded-by: _lock
        self._fired_at: set[tuple[int, int]] = set()  # (rule-id, event-index); guarded-by: _lock

    def on(self, seam: str, mode: str | None = None, payload=None, event: int | None = None):
        """Record one seam event and apply matching rules.  Returns the
        (possibly poisoned) payload.  ``event`` overrides the internal
        per-seam counter for externally-numbered seams (step counters)."""
        to_fire: list[ChaosRule] = []
        with self._lock:
            self._events[seam] += 1
            idx = self._events[seam] if event is None else event
            for rule in self.rules:
                if rule.seam != seam:
                    continue
                if rule.mode is not None and rule.mode != mode:
                    continue
                fired = False
                if idx in rule.at:
                    tag = (id(rule), idx)
                    if tag not in self._fired_at:
                        self._fired_at.add(tag)
                        fired = True
                if not fired and rule.rate > 0.0:
                    fired = self._rng.random() < rule.rate
                if fired:
                    self._injected[(seam, rule.kind)] += 1
                    to_fire.append(rule)
        for rule in to_fire:
            if rule.kind == "latency":
                time.sleep(rule.delay_s)
            elif rule.kind == "call":
                if rule.action is not None:
                    rule.action()
            elif rule.kind == "nan":
                payload = self._poison(payload)
            elif rule.kind == "raise":
                raise InjectedFault(seam, f"event {idx}" if event is not None else "")
        return payload

    def _poison(self, payload):
        """NaN-poison one row of an ndarray payload (copy, never in
        place — the caller may hold other references)."""
        if payload is None:
            return payload
        arr = np.array(payload, copy=True)
        if arr.ndim == 0:
            return np.float32("nan")
        with self._lock:
            row = self._rng.randrange(arr.shape[0])
        arr[row] = np.nan
        return arr

    def stats(self) -> dict:
        with self._lock:
            return {
                "events": dict(self._events),
                "injected": {f"{s}/{k}": n for (s, k), n in self._injected.items()},
                "total_injected": sum(self._injected.values()),
            }
