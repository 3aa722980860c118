"""The port's restart loop, shard reassignment and heartbeat membership
(``repro_torch.distributed.fault``), against the reference and inside the
port.

Mirrors the seven portable tests of ``tests/test_fault.py`` (the
injector, the restart loop's give-up, the three ``reassign_shards``
properties and the two heartbeat lifecycle tests on a fake clock; the
training restart and the elastic re-mesh need the port's LM training and
device mesh, which it does not have yet).  Parity: ``reassign_shards``
gives the reference's assignment on the property tests' cases, with and
without a previous assignment, and one scripted fake clock drives both
packages' ``HeartbeatMonitor`` through equal transitions, callbacks,
``flaps`` and ``deaths``.  Everything here is stdlib: no sleeps, no
threads.
"""

import pytest
from _hypo import given, settings, st  # hypothesis, or deterministic fallback

pytest.importorskip("torch")

from repro.distributed import fault as r_fault  # noqa: E402
from repro_torch.distributed import fault as t_fault  # noqa: E402
from repro_torch.distributed.fault import (  # noqa: E402
    DEAD,
    DRAINING,
    HEALTHY,
    SUSPECT,
    FailureInjector,
    HeartbeatMonitor,
    SimulatedFailure,
    reassign_shards,
    run_with_restarts,
)


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- mirrors of tests/test_fault.py -------------------------------------------


def test_injector_fires_once_per_step():
    inj = FailureInjector(fail_at_steps=(3,))
    inj.check(2)
    with pytest.raises(SimulatedFailure):
        inj.check(3)
    inj.check(3)  # restart passes the same step


def test_run_with_restarts_gives_up():
    calls = {"n": 0}

    def always_fails():
        calls["n"] += 1
        raise SimulatedFailure("boom")

    with pytest.raises(SimulatedFailure):
        run_with_restarts(always_fails, max_restarts=3)
    assert calls["n"] == 4


def test_run_with_restarts_resumes_after_planned_failures():
    """The restart loop re-invokes a job killed at planned steps until it
    completes; each attempt resumes from the last step it reached (the
    stand-in for its checkpoint directory)."""
    inj = FailureInjector(fail_at_steps=(2, 5))
    state = {"step": 0, "attempts": 0}

    def run():
        state["attempts"] += 1
        while state["step"] < 8:
            inj.check(state["step"])
            state["step"] += 1
        return {"steps_done": state["step"]}

    assert run_with_restarts(run) == {"steps_done": 8}
    assert state["attempts"] == 3


@settings(max_examples=20, deadline=None)
@given(
    num_shards=st.integers(1, 64),
    dead=st.sets(st.integers(0, 7), max_size=7),
)
def test_reassign_shards_total_and_deterministic(num_shards, dead):
    live = [w for w in range(8) if w not in dead]
    if not live:
        with pytest.raises(ValueError):
            reassign_shards(num_shards, live)
        return
    a = reassign_shards(num_shards, live)
    b = reassign_shards(num_shards, list(reversed(live)))
    assert a == b  # order-independent (coordination-free)
    got = sorted(s for shards in a.values() for s in shards)
    assert got == list(range(num_shards))  # every shard owned exactly once
    sizes = [len(v) for v in a.values()]
    assert max(sizes) - min(sizes) <= 1  # balanced


@settings(max_examples=30, deadline=None)
@given(
    num_shards=st.integers(1, 64),
    dead=st.sets(st.integers(0, 7), max_size=6),
)
def test_reassign_shards_minimal_movement_on_death(num_shards, dead):
    """Killing workers moves only the dead workers' shards, onto the
    least-loaded survivors, and keeps the result near-balanced."""
    workers = list(range(8))
    before = reassign_shards(num_shards, workers)
    live = [w for w in workers if w not in dead]
    if not live:
        return
    after = reassign_shards(num_shards, live, previous=before)
    got = sorted(s for shards in after.values() for s in shards)
    assert got == list(range(num_shards))
    for w in live:
        assert set(before[w]) <= set(after[w])
    moved = sum(len(after[w]) - len(before[w]) for w in live)
    orphaned = sum(len(before[w]) for w in dead)
    assert moved == orphaned
    sizes = [len(v) for v in after.values()]
    assert max(sizes) - min(sizes) <= 1


@settings(max_examples=30, deadline=None)
@given(num_shards=st.integers(1, 64), joiners=st.integers(1, 4))
def test_reassign_shards_join_moves_nothing(num_shards, joiners):
    """A worker joining moves zero shards, and reassignment with an
    unchanged membership is idempotent."""
    workers = list(range(6))
    before = reassign_shards(num_shards, workers)
    grown = workers + [100 + j for j in range(joiners)]
    after = reassign_shards(num_shards, grown, previous=before)
    for w in workers:
        assert after[w] == before[w]
    for j in range(joiners):
        assert after[100 + j] == []
    assert reassign_shards(num_shards, workers, previous=before) == before


def test_heartbeat_lifecycle_fake_clock():
    """healthy → suspect → dead under staleness; a beat from suspect
    flaps back to healthy; dead is sticky until re-registration."""
    clock = _Clock()
    events = []
    mon = HeartbeatMonitor(
        suspect_after_s=1.0,
        dead_after_s=3.0,
        clock=clock,
        on_change=lambda m, old, new: events.append((m, old, new)),
    )
    mon.register("a")
    mon.register("b")
    assert mon.poll() == [] and mon.states() == {"a": HEALTHY, "b": HEALTHY}

    clock.t = 1.5  # past suspect, before dead
    mon.beat("b")
    assert mon.poll() == [("a", HEALTHY, SUSPECT)]
    assert mon.state("b") == HEALTHY

    clock.t = 2.0  # a beat from suspect recovers (a flap, counted)
    mon.beat("a")
    assert mon.state("a") == HEALTHY and mon.flaps == 1
    assert ("a", SUSPECT, HEALTHY) in events

    clock.t = 5.5  # a: stale 3.5 s -> dead (skipping suspect); b: 4.0 -> dead
    changes = mon.poll()
    assert set(changes) == {("a", HEALTHY, DEAD), ("b", HEALTHY, DEAD)}
    assert mon.deaths == 2

    mon.beat("a")  # dead is sticky: beats dropped
    assert mon.state("a") == DEAD
    assert mon.members(HEALTHY) == []

    mon.register("a")  # replacement re-admits under the same id
    assert mon.state("a") == HEALTHY
    assert mon.members(HEALTHY, DEAD) == ["a", "b"]


def test_heartbeat_draining_and_mark_validation():
    mon = HeartbeatMonitor(suspect_after_s=10.0, dead_after_s=20.0)
    mon.register("a")
    mon.mark("a", DRAINING)
    assert mon.state("a") == DRAINING
    assert mon.members(HEALTHY) == []  # no new work while draining
    mon.mark("a", DEAD)
    assert mon.deaths == 1
    with pytest.raises(ValueError):
        mon.mark("a", "zombie")
    with pytest.raises(ValueError):
        HeartbeatMonitor(suspect_after_s=2.0, dead_after_s=1.0)


def test_heartbeat_callbacks_run_outside_the_monitor_lock():
    """``on_change`` may re-enter the monitor (the replica set's rescue
    reads ``members()``): a callback that takes the lock must not
    deadlock, from ``poll``, ``beat`` or ``mark``."""
    clock = _Clock()
    seen = []
    mon = HeartbeatMonitor(suspect_after_s=1.0, dead_after_s=2.0, clock=clock)
    mon._on_change = lambda m, old, new: seen.append((m, new, mon.members(HEALTHY, SUSPECT)))
    mon.register("a")
    mon.register("b")
    clock.t = 1.5
    mon.beat("b")
    mon.poll()
    mon.beat("a")
    mon.mark("b", DRAINING)
    assert seen == [
        ("a", SUSPECT, ["a", "b"]),
        ("a", HEALTHY, ["a", "b"]),
        ("b", DRAINING, ["a"]),
    ]


# -- parity with the reference -------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(
    num_shards=st.integers(1, 64),
    dead=st.sets(st.integers(0, 7), max_size=7),
    joiners=st.integers(0, 3),
)
def test_reassign_shards_matches_reference(num_shards, dead, joiners):
    workers = list(range(8))
    live = [w for w in workers if w not in dead] + [100 + j for j in range(joiners)]
    assert reassign_shards(num_shards, workers) == r_fault.reassign_shards(num_shards, workers)
    before = reassign_shards(num_shards, workers)
    if not live:
        for fn in (reassign_shards, r_fault.reassign_shards):
            with pytest.raises(ValueError):
                fn(num_shards, live, previous=before)
        return
    got = reassign_shards(num_shards, list(reversed(live)), previous=before)
    want = r_fault.reassign_shards(num_shards, live, previous=before)
    assert got == want


def test_heartbeat_monitor_matches_reference_on_one_script():
    """One scripted fake clock, the same beats, polls and marks: both
    monitors make equal transitions, fire equal callbacks and count
    equal flaps and deaths at every step."""
    script = [
        ("register", "a"), ("register", "b"), ("register", "c"),
        ("t", 0.02), ("beat", "a"), ("poll",),
        ("t", 0.04), ("beat", "b"), ("poll",),  # c suspect
        ("t", 0.05), ("beat", "c"), ("poll",),  # c flaps back
        ("t", 0.09), ("beat", "a"), ("poll",),  # b suspect
        ("t", 0.11), ("poll",),  # b dead
        ("beat", "b"), ("mark", "a", DRAINING), ("t", 0.20), ("poll",),
        ("register", "b"), ("mark", "c", DEAD), ("mark", "c", DEAD),
        ("t", 0.23), ("beat", "b"), ("t", 0.30), ("poll",),
        ("deregister", "a"), ("t", 0.50), ("poll",),
    ]

    def drive(mod):
        clock = _Clock()
        events = []
        mon = mod.HeartbeatMonitor(
            suspect_after_s=0.03, dead_after_s=0.06, clock=clock,
            on_change=lambda m, old, new: events.append((m, old, new)),
        )
        trace = []
        for op, *args in script:
            if op == "t":
                clock.t = args[0]
                continue
            out = getattr(mon, op)(*args)
            trace.append((op, args, out, mon.states(), mon.flaps, mon.deaths))
        return trace, events

    got, got_events = drive(t_fault)
    want, want_events = drive(r_fault)
    assert got == want
    assert got_events == want_events
    assert got[-1][4] >= 1 and got[-1][5] >= 2  # the script flapped and killed
    assert (HEALTHY, SUSPECT, DEAD, DRAINING) == (
        r_fault.HEALTHY, r_fault.SUSPECT, r_fault.DEAD, r_fault.DRAINING
    )
