"""Chaos injection for the serving seams (the port's own copy of the
chaos part of ``repro.distributed.fault``).

The serving stack calls ``injector.on(seam, ...)`` at its named seams —
``cache_fetch``, ``encode``, ``dispatch``, ``readout`` — and rules
decide, deterministically from a seeded RNG, whether to raise a
transient :class:`InjectedFault`, sleep a latency spike, poison a payload
row with NaNs, or run an arbitrary action (e.g. racing an eviction).  A
server with no injector attached pays a single attribute check.

The draws are the reference's: the same rules and seed fire at the same
events and poison the same rows in both packages.

``FailureInjector`` (a step-counter special case of the injector) and
``run_with_restarts`` drive a job killed at planned steps back through
its checkpoint directory.  ``reassign_shards`` re-partitions shards over
the live workers deterministically, moving only a dead worker's shards
when given the previous assignment.  ``HeartbeatMonitor`` tracks member
liveness from posted heartbeats (healthy -> suspect -> dead, plus the
deliberate draining state) under an injectable clock; the replicated
video search (``launch/replica.py``) is built on it.  All of it is
stdlib, with the reference's semantics.
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


@dataclasses.dataclass
class FailureInjector:
    """Kills the 'job' when the step counter hits each planned failure.

    Retained API from the training loop; now a thin special case of
    :class:`ChaosInjector` (a single ``raise`` rule on a ``step`` seam
    with deterministic ``at`` indices — each fires once)."""

    fail_at_steps: tuple[int, ...] = ()

    def __post_init__(self):
        self._chaos = ChaosInjector(
            [ChaosRule(seam="step", kind="raise", at=tuple(self.fail_at_steps))]
        )

    def check(self, step: int) -> None:
        try:
            self._chaos.on("step", event=step)
        except InjectedFault:
            raise SimulatedFailure(f"injected failure at step {step}") from None


def run_with_restarts(
    make_run: Callable[[], dict],
    max_restarts: int = 8,
) -> dict:
    """Cluster-restart loop: re-invoke the job until it completes.

    ``make_run`` builds and runs the training loop *from its checkpoint
    directory* (i.e. it must internally resume from latest_step).
    Returns the final metrics dict of the successful run.
    """
    for attempt in range(max_restarts + 1):
        try:
            return make_run()
        except SimulatedFailure:
            if attempt == max_restarts:
                raise
            continue
    raise RuntimeError("unreachable")


def reassign_shards(
    num_shards: int,
    live_workers: list[int],
    previous: dict[int, list[int]] | None = None,
) -> dict[int, list[int]]:
    """Deterministic shard→worker map over the currently-live workers.

    Pure function of its inputs: every surviving worker computes the same
    assignment with no coordination (``live_workers`` order is
    irrelevant — the map is keyed on the *set*).

    Without ``previous`` the shards spread round-robin by index (the
    cold-start balanced layout).  With ``previous`` (the assignment in
    force before the membership change) the re-partition is **minimal
    movement**: a shard whose previous owner is still live stays put;
    only orphan shards — owned by a now-dead worker, or new shards with
    no previous owner — move, placed greedily on the least-loaded live
    worker (ties broken by worker id, orphans in shard-index order).
    Consequences, pinned by property test (tests/test_torch_fault.py):

    * worker death from a balanced assignment re-balances (max−min ≤ 1
      after redistribution) while touching only the dead worker's shards;
    * worker *join* moves nothing — stability is preferred over
      rebalancing onto the newcomer (it picks up orphans only), so a
      flapping worker cannot thrash the whole partition;
    * same live set + same previous ⇒ identical output (idempotent).
    """
    if not live_workers:
        raise ValueError("no live workers")
    workers = sorted(set(live_workers))
    assignment: dict[int, list[int]] = {w: [] for w in workers}
    if previous is None:
        for shard in range(num_shards):
            assignment[workers[shard % len(workers)]].append(shard)
        return assignment
    owner: dict[int, int] = {}
    for w in sorted(previous):
        if w not in assignment:
            continue  # dead worker: its shards become orphans
        for s in previous[w]:
            if 0 <= s < num_shards:
                owner[s] = w
    for s, w in owner.items():
        assignment[w].append(s)
    # place orphans least-loaded-first; (load, id) ordering keeps the
    # choice deterministic under equal loads
    for s in range(num_shards):
        if s in owner:
            continue
        w = min(workers, key=lambda w: (len(assignment[w]), w))
        assignment[w].append(s)
    for shards in assignment.values():
        shards.sort()
    return assignment


# ---------------------------------------------------------------------------
# Heartbeat-driven membership (replica lifecycle)
# ---------------------------------------------------------------------------


# The replica lifecycle states (the reference's docs/serving.md has the
# full machine):
# healthy -> suspect -> dead is driven by heartbeat staleness; draining
# is entered deliberately (decommission) and ends in dead.
HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
DRAINING = "draining"


class HeartbeatMonitor:
    """Liveness tracking from posted heartbeats: healthy → suspect →
    dead, with deliberate ``draining``.

    Members are opaque string ids — the monitor neither spawns nor owns
    them, so the same machinery serves thread-backed replicas now and
    multi-process mesh workers later.  A member posts
    ``beat(id)``; ``poll()`` applies the staleness thresholds under the
    injectable ``clock`` and returns the transitions it made, invoking
    ``on_change(member, old, new)`` for each *outside* the monitor lock
    (callbacks may re-enter ``state()``/``members()``).

    Transitions:

    * no beat for ``suspect_after_s``  → healthy → suspect
    * no beat for ``dead_after_s``     → suspect (or healthy) → dead
    * a beat from suspect              → back to healthy (a flap)
    * ``mark(id, DRAINING)``           → no new work; still beating
    * dead is sticky: beats from a dead member are dropped until it is
      re-registered (a replacement replica registers under the same id)
    """

    def __init__(
        self,
        suspect_after_s: float = 0.06,
        dead_after_s: float = 0.15,
        clock: Callable[[], float] = time.monotonic,
        on_change: Callable[[str, str, str], None] | None = None,
    ):
        if dead_after_s <= suspect_after_s:
            raise ValueError("dead_after_s must exceed suspect_after_s")
        self.suspect_after_s = float(suspect_after_s)
        self.dead_after_s = float(dead_after_s)
        self._clock = clock
        self._on_change = on_change
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}  # guarded-by: _lock
        self._states: dict[str, str] = {}  # guarded-by: _lock
        self.flaps = 0  # suspect -> healthy recoveries; guarded-by: _lock
        self.deaths = 0  # guarded-by: _lock

    def register(self, member: str) -> None:
        """(Re-)admit a member as healthy with a fresh heartbeat."""
        now = self._clock()
        with self._lock:
            self._last[member] = now
            self._states[member] = HEALTHY

    def deregister(self, member: str) -> None:
        with self._lock:
            self._last.pop(member, None)
            self._states.pop(member, None)

    def beat(self, member: str) -> None:
        """Record a heartbeat.  A beat flips suspect back to healthy (a
        flap — counted); beats from dead/unknown members are dropped."""
        now = self._clock()
        flapped = False
        with self._lock:
            state = self._states.get(member)
            if state is None or state == DEAD:
                return
            self._last[member] = now
            if state == SUSPECT:
                self._states[member] = HEALTHY
                self.flaps += 1
                flapped = True
        if flapped and self._on_change is not None:
            self._on_change(member, SUSPECT, HEALTHY)

    def mark(self, member: str, state: str) -> None:
        """Force a member's state (deliberate transitions: ``draining``
        on decommission, ``dead`` on a known kill)."""
        if state not in (HEALTHY, SUSPECT, DEAD, DRAINING):
            raise ValueError(f"unknown member state {state!r}")
        with self._lock:
            old = self._states.get(member)
            if old is None or old == state:
                return
            self._states[member] = state
            if state == DEAD:
                self.deaths += 1
        if self._on_change is not None:
            self._on_change(member, old, state)

    def poll(self) -> list[tuple[str, str, str]]:
        """Apply the staleness thresholds once; returns (and reports via
        ``on_change``) the ``(member, old, new)`` transitions made."""
        now = self._clock()
        changes: list[tuple[str, str, str]] = []
        with self._lock:
            for member, state in list(self._states.items()):
                if state == DEAD:
                    continue
                stale = now - self._last.get(member, now)
                if stale >= self.dead_after_s:
                    changes.append((member, state, DEAD))
                    self._states[member] = DEAD
                    self.deaths += 1
                elif stale >= self.suspect_after_s and state == HEALTHY:
                    changes.append((member, state, SUSPECT))
                    self._states[member] = SUSPECT
        if self._on_change is not None:
            for member, old, new in changes:
                self._on_change(member, old, new)
        return changes

    def state(self, member: str) -> str | None:
        with self._lock:
            return self._states.get(member)

    def states(self) -> dict[str, str]:
        with self._lock:
            return dict(self._states)

    def members(self, *states: str) -> list[str]:
        """Member ids currently in any of ``states`` (sorted — callers
        iterate deterministically)."""
        want = states or (HEALTHY,)
        with self._lock:
            return sorted(
                m for m, s in self._states.items() if s in want
            )
