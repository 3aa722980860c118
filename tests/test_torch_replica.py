"""The port's replicated video search (``repro_torch.launch.replica``):
heartbeat failover, hedging, draining and durable warm restart, against
the reference and inside the port.

Mirrors the 15 tests of ``tests/test_replica.py`` and
``test_race_smoke.py::test_replica_set_race_smoke_membership_churn`` on
the port (``device="cpu"``, the plain torch versions of the kernels) at
the reference tests' geometry: 12x12 frames, 8-frame windows, kernels
(2, 1, 3, 4, 3).  Where the reference times a straggler with a chaos
latency and asserts on the wall clock, these mirrors hold the replica's
dispatch on a ``threading.Event`` gate (a chaos ``call`` rule) and prove
the claim while the gate is still shut: a rescue or a hedge resolved the
future without the straggler's help.  Conditions are awaited with a
deadline; heartbeat thresholds are wide enough that a loaded CPU cannot
starve a healthy replica into a death.

Parity with the reference: equal ``kernel_hash`` digests; a tenant
manifest written by either package's ``ReplicaSet`` (one tenant on the
physical pipeline with its own SLM and atomic configs) loads through the
other's ``load_tenant_manifest`` into equal specs; one clip through both
packages' ``ReplicaSet.search`` gives scores within relative L2 1e-5 and
equal peak frames outside the reference's near-ties.
"""

import dataclasses
import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

from repro.core import atomic as r_atomic  # noqa: E402
from repro.core import fidelity as r_fid  # noqa: E402
from repro.core import optics as r_optics  # noqa: E402
from repro.launch import replica as r_replica  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro_torch.core import atomic, optics  # noqa: E402
from repro_torch.core import fidelity as fid  # noqa: E402
from repro_torch.distributed.fault import (  # noqa: E402
    DEAD,
    HEALTHY,
    ChaosInjector,
    ChaosRule,
)
from repro_torch.launch import replica as t_replica  # noqa: E402
from repro_torch.launch.replica import (  # noqa: E402
    HedgePolicy,
    ReplicaSet,
    _TenantSpec,
    kernel_hash,
    load_tenant_manifest,
)
from repro_torch.launch.resilience import (  # noqa: E402
    DeadlineExceeded,
    ReplicaUnavailable,
    ServingError,
)
from repro_torch.launch.serve import VideoSearchConfig, VideoSearchServer  # noqa: E402

TIMEOUT = 60  # seconds any result() or awaited condition may take
# heartbeat thresholds for the timing-free mirrors: a stalled replica is
# declared dead within a second, a healthy one never under CPU load
WIDE = dict(suspect_after_s=0.3, dead_after_s=0.6, heartbeat_interval_s=0.02,
            poll_interval_s=0.005)


def _kernels(seed, O=2, kt=3):
    rng = np.random.RandomState(seed)
    return rng.randn(O, 1, 3, 4, kt).astype(np.float32)


def _clip(seed, T=20, H=12, W=12):
    rng = np.random.RandomState(100 + seed)
    return rng.rand(1, 1, H, W, T).astype(np.float32)


def _build_server():
    return VideoSearchServer(
        frame_hw=(12, 12), cfg=VideoSearchConfig(window_frames=8, device="cpu")
    )


def _warm(rs, tenant="t0", clip=None):
    """Serve one clip on every replica directly, before any test timing."""
    clip = _clip(0) if clip is None else clip
    for name in list(rs.monitor.states()):
        rs._replicas[name].submit(tenant, clip, block=True).result(timeout=TIMEOUT)


def _make_set(n=2, **kw):
    kw.setdefault("hedge", HedgePolicy(enabled=False))
    rs = ReplicaSet(_build_server, n_replicas=n, **kw)
    rs.add_tenant("t0", _kernels(0))
    return rs


def _gate(rs, name):
    """Hold every dispatch of replica ``name`` until the returned event is
    set (at most ``TIMEOUT`` s); ``entered`` is set once one is held."""
    release, entered = threading.Event(), threading.Event()

    def hold():
        entered.set()
        release.wait(timeout=TIMEOUT)

    rs._replicas[name].server.chaos = ChaosInjector(
        [ChaosRule(seam="dispatch", kind="call", rate=1.0, action=hold)]
    )
    release.entered = entered
    return release


def _wait_for(cond, what, timeout=TIMEOUT):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _settled(rs):
    """Every outer future retired (its done-callback runs after waiters
    wake, so the counters settle a moment after ``result()``)."""
    _wait_for(lambda: rs.metrics()["inflight"] == 0, "the set's ledger to settle")
    return rs.metrics()


# -- dispatch + fan-out ----------------------------------------------------


def test_tenant_fanout_serves_bitwise_identical_scores():
    """Every replica records the same gratings and serves bitwise-equal
    scores — the property hedging and failover rely on."""
    with _make_set(n=3) as rs:
        clip = _clip(1)
        outs = [
            rs._replicas[name].submit("t0", clip, block=True).result(timeout=TIMEOUT)
            for name in sorted(rs.monitor.states())
        ]
        ref = np.asarray(outs[0]["scores"])
        for out in outs[1:]:
            np.testing.assert_array_equal(ref, np.asarray(out["scores"]))
        got = rs.search("t0", clip)
        np.testing.assert_array_equal(ref, np.asarray(got["scores"]))


def test_no_healthy_replica_is_typed_not_hung():
    with _make_set(n=1) as rs:
        rs.kill_replica("r0")
        fut = rs.submit("t0", _clip(0))
        with pytest.raises(ReplicaUnavailable) as ei:
            fut.result(timeout=TIMEOUT)
        assert ei.value.tenant == "t0"
        assert _settled(rs)["unroutable"] == 1


def test_deadline_passes_through_failover_untouched():
    """DeadlineExceeded is client-attributable: it resolves the outer
    future as-is instead of burning failover attempts."""
    with _make_set(n=2, default_deadline_s=0.0005) as rs:
        _warm(rs)
        fut = rs.submit("t0", _clip(0), block=True)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=TIMEOUT)
        assert rs.metrics()["failovers"] == 0


# -- failover --------------------------------------------------------------


def test_kill_fails_over_inflight_without_losing_futures():
    """Killing a replica with one attempt in its batch and more queued
    re-homes the queued ones: every future resolves with a result, and
    the survivor's retry budget is untouched (failover is a membership
    event)."""
    with _make_set(n=2, scheduler_kwargs={"max_batch": 1}) as rs:
        _warm(rs)
        gate = _gate(rs, "r0")
        futs = [rs.submit("t0", _clip(i % 3), block=True) for i in range(8)]
        assert gate.entered.wait(TIMEOUT)  # r0 holds an attempt, the rest queue
        r0 = rs._replicas["r0"]
        killer = threading.Thread(target=rs.kill_replica, args=("r0",))
        killer.start()  # closing r0's scheduler waits for its batch
        _wait_for(r0._sched._closed.is_set, "r0's scheduler to close")
        gate.set()
        killer.join(timeout=TIMEOUT)
        assert not killer.is_alive()
        for f in futs:
            f.result(timeout=TIMEOUT)  # raises if any resolved with an error
        m = _settled(rs)
        assert m["failovers"] > 0
        assert m["completed"] == m["submitted"]
        assert m["lost_futures"] == 0
        assert rs._replicas["r1"].metrics()["retries"] == 0


def test_stall_triggers_heartbeat_rescue():
    """A wedged replica (heartbeats stop, its dispatch held) is declared
    dead by staleness and its in-flight work is re-dispatched by the
    rescue path: every future resolves while the wedged replica still
    holds its attempts."""
    with _make_set(n=2, **WIDE) as rs:
        _warm(rs)
        gate = _gate(rs, "r0")
        futs = [rs.submit("t0", _clip(i % 3), block=True) for i in range(6)]
        rs.stall_replica("r0")
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert not gate.is_set()  # nobody waited for r0's inner futures
        m = _settled(rs)
        assert m["rescued"] > 0
        assert m["states"]["r0"] == DEAD
        assert m["states"]["r1"] == HEALTHY
        gate.set()


def test_revive_readmits_stalled_replica():
    with _make_set(n=2, **WIDE) as rs:
        rs.stall_replica("r0")
        _wait_for(lambda: rs.monitor.state("r0") == DEAD, "r0 to be declared dead")
        rs.revive_replica("r0")
        assert rs.monitor.state("r0") == HEALTHY
        # a killed replica cannot be revived — it lost its state
        rs.kill_replica("r1")
        with pytest.raises(ValueError):
            rs.revive_replica("r1")


# -- hedging ---------------------------------------------------------------


def test_hedge_duplicates_straggler_and_first_result_wins():
    """A straggling request is duplicated after the hedge delay; the
    duplicate's result resolves the future while the straggler still
    holds its attempt."""
    hedge = HedgePolicy(enabled=True, cold_delay_s=0.05, min_samples=10**9)
    with _make_set(n=2, hedge=hedge, poll_interval_s=0.005) as rs:
        _warm(rs)
        gate = _gate(rs, "r0")
        futs = [rs.submit("t0", _clip(i % 3), block=True) for i in range(6)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert not gate.is_set()
        m = _settled(rs)
        assert m["hedges"] > 0
        assert m["hedge_wins"] > 0
        assert m["completed"] == m["submitted"]
        gate.set()


def test_hedge_bouncing_off_full_queue_never_fails_the_request():
    """A hedge rejected at admission (queue full on every alternate
    replica) is dropped, not surfaced: the primary attempt is still in
    flight and resolves the outer future."""
    hedge = HedgePolicy(enabled=True, cold_delay_s=0.03, min_samples=10**9)
    with _make_set(
        n=2,
        hedge=hedge,
        poll_interval_s=0.005,
        scheduler_kwargs={"max_queue": 1, "max_batch": 1, "batch_wait_s": 0.0},
    ) as rs:
        _warm(rs)
        gates = [_gate(rs, name) for name in ("r0", "r1")]
        futs = []
        submitter = threading.Thread(
            target=lambda: futs.extend(rs.submit("t0", _clip(i % 3), block=True) for i in range(4))
        )
        submitter.start()  # a full queue backpressures the submitter
        _wait_for(lambda: sum(rs._replicas[n].metrics()["rejected"] for n in ("r0", "r1")) > 0,
                  "a hedge to bounce off a full queue")
        for g in gates:
            g.set()
        submitter.join(timeout=TIMEOUT)
        assert not submitter.is_alive() and len(futs) == 4
        for f in futs:
            f.result(timeout=TIMEOUT)  # raises if a bounced hedge leaked out
        m = _settled(rs)
        assert m["completed"] == m["submitted"]
        assert m["lost_futures"] == 0


def test_hedge_respects_remaining_deadline_budget():
    """A request whose deadline has already passed is never duplicated."""
    hedge = HedgePolicy(enabled=True, cold_delay_s=0.02, min_samples=10**9)
    with _make_set(n=2, hedge=hedge, poll_interval_s=0.005, default_deadline_s=0.01) as rs:
        _warm(rs)
        gates = [_gate(rs, name) for name in ("r0", "r1")]
        futs = [rs.submit("t0", _clip(i % 3), block=True) for i in range(4)]
        for f in futs:
            with pytest.raises(DeadlineExceeded):
                f.result(timeout=TIMEOUT)
        # hedge delay (0.02) > deadline (0.01): every hedge would have
        # been scheduled past the budget, so none fired
        assert rs.metrics()["hedges"] == 0
        for g in gates:
            g.set()


# -- draining --------------------------------------------------------------


def test_drain_finishes_inflight_then_decommissions():
    with _make_set(n=2) as rs:
        _warm(rs)
        futs = [rs.submit("t0", _clip(i % 3), block=True) for i in range(4)]
        rs.drain_replica("r0", timeout_s=TIMEOUT)
        assert rs.monitor.state("r0") is None  # deregistered, not dead
        assert "r0" not in rs.metrics()["replicas"]
        for f in futs:
            f.result(timeout=TIMEOUT)
        rs.search("t0", _clip(1))  # new work routes to the survivor only
        assert rs.monitor.members(HEALTHY) == ["r1"]


# -- durable manifest + warm restart ---------------------------------------


def test_tenant_manifest_roundtrip_and_hash_guard():
    spec = _TenantSpec(name="t0", kernels=_kernels(0))
    entry = spec.manifest_entry()
    back = _TenantSpec.from_manifest("t0", entry, spec.kernels)
    np.testing.assert_array_equal(back.kernels, spec.kernels)
    assert back.fidelity is None and back.slm is None and back.atoms is None
    bad = spec.kernels.copy()
    bad[0, 0, 0, 0, 0] += 1.0
    with pytest.raises(ValueError, match="hash mismatch"):
        _TenantSpec.from_manifest("t0", entry, bad)
    # the hash covers shape and dtype, not just bytes
    assert kernel_hash(spec.kernels) != kernel_hash(spec.kernels.reshape(-1))


def test_manifest_persists_through_checkpoint_layer(tmp_path):
    ckpt = str(tmp_path / "manifest")
    with _make_set(n=2, ckpt_dir=ckpt) as rs:
        rs.add_tenant("t1", torch.from_numpy(_kernels(1)))  # a tensor: held on the host
        specs = load_tenant_manifest(ckpt)
        assert sorted(specs) == ["t0", "t1"]
        assert isinstance(specs["t1"].kernels, np.ndarray)
        np.testing.assert_array_equal(specs["t1"].kernels, _kernels(1))


def test_warm_restart_is_bitwise_and_gated_by_admission(tmp_path):
    """A replacement rebuilt from the durable manifest serves scores
    bitwise-equal to the survivors, and is admitted only after proving
    it."""
    ckpt = str(tmp_path / "manifest")
    with _make_set(n=2, ckpt_dir=ckpt) as rs:
        clip = _clip(2)
        want = rs.search("t0", clip)
        rs.kill_replica("r0")
        assert rs.monitor.state("r0") == DEAD
        replica = rs.replace_replica("r0")
        assert rs.monitor.state("r0") == HEALTHY
        assert replica.mesh is None and replica.metrics()["mesh"] is None
        got = replica.submit("t0", clip, block=True).result(timeout=TIMEOUT)
        np.testing.assert_array_equal(np.asarray(want["scores"]), np.asarray(got["scores"]))


def _build_mesh_server():
    """A replica server on a (1, 2) logical mesh of the CPU."""
    return VideoSearchServer(
        frame_hw=(12, 12),
        cfg=VideoSearchConfig(
            window_frames=8, mesh_shape=(1, 2), mesh_devices=("cpu",) * 2, device="cpu"
        ),
    )


def test_replica_mesh_and_status_key():
    """A replica's mesh is its server's, each replica owns its own, the
    status carries the shape, and the scores are bitwise a single-device
    set's."""
    with _make_set(n=2) as plain, ReplicaSet(
        _build_mesh_server, n_replicas=2, hedge=HedgePolicy(enabled=False)
    ) as rs:
        rs.add_tenant("t0", _kernels(0))
        for name in ("r0", "r1"):
            replica = rs._replicas[name]
            assert replica.mesh is replica.server.mesh
            assert replica.mesh.shape == {"data": 1, "model": 2}
            assert replica.metrics()["mesh"] == {"data": 1, "model": 2}
        assert rs._replicas["r0"].mesh is not rs._replicas["r1"].mesh
        assert plain._replicas["r0"].mesh is None
        assert plain._replicas["r0"].metrics()["mesh"] is None
        clip = _clip(3)
        want, got = plain.search("t0", clip), rs.search("t0", clip)
        np.testing.assert_array_equal(
            np.asarray(want["scores"]).view(np.int32), np.asarray(got["scores"]).view(np.int32)
        )


def test_replacement_replica_builds_its_own_mesh(tmp_path):
    """A warm-restarted replica owns a new mesh, never the dead one's,
    and passes the bitwise admission probe on it."""
    ckpt = str(tmp_path / "manifest")
    with ReplicaSet(
        _build_mesh_server, n_replicas=2, hedge=HedgePolicy(enabled=False), ckpt_dir=ckpt
    ) as rs:
        rs.add_tenant("t0", _kernels(0))
        clip = _clip(2)
        want = rs.search("t0", clip)
        dead_mesh = rs._replicas["r0"].mesh
        rs.kill_replica("r0")
        replica = rs.replace_replica("r0")
        assert replica.mesh is not None and replica.mesh is not dead_mesh
        assert replica.mesh is not rs._replicas["r1"].mesh
        assert replica.metrics()["mesh"] == {"data": 1, "model": 2}
        got = replica.submit("t0", clip, block=True).result(timeout=TIMEOUT)
        np.testing.assert_array_equal(np.asarray(want["scores"]), np.asarray(got["scores"]))


def test_replace_requires_dead_replica_and_healthy_reference(tmp_path):
    ckpt = str(tmp_path / "manifest")
    with _make_set(n=1, ckpt_dir=ckpt) as rs:
        with pytest.raises(ValueError, match="still live"):
            rs.replace_replica("r0")
        rs.kill_replica("r0")
        with pytest.raises(ReplicaUnavailable):
            rs.replace_replica("r0")
        assert rs.monitor.state("r0") == DEAD


def test_admission_probe_refuses_a_replica_that_computes_differently(tmp_path):
    """A replacement whose arithmetic differs (here: bf16 gratings) fails
    the bitwise probe, is closed, and never joins the membership."""
    ckpt = str(tmp_path / "manifest")
    with _make_set(n=2, ckpt_dir=ckpt) as rs:
        rs.kill_replica("r0")
        rs._build_server = lambda: VideoSearchServer(
            frame_hw=(12, 12),
            cfg=VideoSearchConfig(window_frames=8, grating_dtype="bfloat16", device="cpu"),
        )
        with pytest.raises(ValueError, match="admission probe failed"):
            rs.replace_replica("r0")
        assert rs.monitor.state("r0") == DEAD
        assert rs._replicas["r0"].killed


# -- shutdown --------------------------------------------------------------


def test_close_resolves_every_inflight_future():
    rs = _make_set(n=2)
    _warm(rs)
    gates = [_gate(rs, name) for name in ("r0", "r1")]
    futs = [rs.submit("t0", _clip(i % 3), block=True) for i in range(6)]
    closer = threading.Thread(target=rs.close)
    closer.start()  # closing a replica waits for its held batch
    _wait_for(lambda: rs._replicas["r0"]._sched._closed.is_set(), "the first replica to close")
    for g in gates:
        g.set()
    closer.join(timeout=TIMEOUT)
    assert not closer.is_alive()
    for f in futs:
        try:
            f.result(timeout=TIMEOUT)
        except ServingError:
            pass  # SchedulerClosed (or a completed straggler) — typed
    assert all(f.done() for f in futs)
    rs.close()  # idempotent


# -- race smoke (mirror of test_race_smoke.py) ------------------------------


def test_replica_set_race_smoke_membership_churn():
    """8 threads hammer a 3-replica set under chaos latency: submitters
    race kill and stall/revive churn.  Every future resolves (a result or
    a typed ServingError), the ledger accounts for every submission, and
    no future is lost."""
    rs = ReplicaSet(
        _build_server,
        n_replicas=3,
        hedge=HedgePolicy(enabled=True, cold_delay_s=0.05, min_samples=10**9),
        suspect_after_s=0.04,
        dead_after_s=0.1,
        poll_interval_s=0.005,
        default_deadline_s=20.0,
    )
    rs.add_tenant("t0", _kernels(0))
    clip = _clip(0)
    for name in list(rs.monitor.states()):
        rs._replicas[name].submit("t0", clip, block=True).result(timeout=TIMEOUT)
    for i, name in enumerate(("r1", "r2")):
        rs._replicas[name].server.chaos = ChaosInjector(
            [ChaosRule(seam="dispatch", kind="latency", rate=0.5, delay_s=0.03)], seed=i
        )
    futures, flock, errors = [], threading.Lock(), []
    stop = threading.Event()

    def submitter(seed):
        rng = random.Random(seed)
        for _ in range(25):
            f = rs.submit("t0", _clip(rng.randrange(3)), block=True)
            with flock:
                futures.append(f)
            time.sleep(rng.uniform(0, 0.004))

    def staller(seed, name):
        rng = random.Random(seed)
        while not stop.is_set():
            try:
                rs.stall_replica(name)
                time.sleep(rng.uniform(0.005, 0.03))
                rs.revive_replica(name)
            except (KeyError, ValueError):
                return  # replica was killed/replaced under us — fine
            time.sleep(rng.uniform(0.005, 0.02))

    def killer():
        time.sleep(0.08)
        rs.kill_replica("r1")

    threads = (
        [threading.Thread(target=submitter, args=(i,)) for i in range(5)]
        + [threading.Thread(target=staller, args=(10 + i, "r2")) for i in range(2)]
        + [threading.Thread(target=killer)]
    )
    for t in threads:
        t.start()
    for t in threads[:5]:
        t.join(timeout=120)
    stop.set()
    for t in threads[5:]:
        t.join(timeout=120)
    assert all(not t.is_alive() for t in threads), "hammer thread hung"

    ok = typed = 0
    for f in futures:
        try:
            f.result(timeout=TIMEOUT)
            ok += 1
        except ServingError:
            typed += 1
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)
    assert not errors, errors[:3]
    assert ok + typed == len(futures) == 125  # 100 % resolution, zero hangs
    assert ok > 0
    m = _settled(rs)
    assert m["lost_futures"] == 0
    assert m["submitted"] == len(futures)
    assert m["completed"] + m["failed"] + m["inflight"] == m["submitted"]
    rs.close()


# -- parity with the reference ----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_kernel_hash_matches_reference(dtype):
    k = (_kernels(7) * 100).astype(dtype)
    assert kernel_hash(k) == r_replica.kernel_hash(k)
    assert kernel_hash(k[:, :, :2]) == r_replica.kernel_hash(np.asfortranarray(k[:, :, :2]))


def _tenant_args(fid_mod, optics_mod, atomic_mod):
    """Two tenants: server defaults, and the physical pipeline with its
    own SLM and atomic configs."""
    return [
        ("t0", _kernels(0), {}),
        ("t1", _kernels(1), {
            "fidelity": fid_mod.physical(),
            "slm": optics_mod.SLMConfig(bits=6),
            "atoms": atomic_mod.AtomicConfig(t2_s=2e-3, ihb_profile="lorentzian"),
        }),
    ]


def _ref_build():
    return r_serve.VideoSearchServer(
        frame_hw=(12, 12), cfg=r_serve.VideoSearchConfig(window_frames=8, readout_topk=2)
    )


def _port_build():
    return VideoSearchServer(
        frame_hw=(12, 12), cfg=VideoSearchConfig(window_frames=8, readout_topk=2, device="cpu")
    )


def _assert_specs_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        np.testing.assert_array_equal(g.kernels, w.kernels)
        assert g.manifest_entry() == w.manifest_entry()
        for a, b in ((g.slm, w.slm), (g.atoms, w.atoms)):
            assert (a is None) == (b is None)
            if a is not None:
                assert type(a).__name__ == type(b).__name__
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (g.fidelity is None) == (w.fidelity is None)
        if g.fidelity is not None:
            assert [type(s).__name__ for s in g.fidelity.stages] == [
                type(s).__name__ for s in w.fidelity.stages
            ]
            assert [dataclasses.asdict(s) for s in g.fidelity.stages] == [
                dataclasses.asdict(s) for s in w.fidelity.stages
            ]
            assert g.fidelity.name == w.fidelity.name


def test_reference_tenant_manifest_loads_through_port(tmp_path):
    ckpt = str(tmp_path / "manifest")
    with r_replica.ReplicaSet(_ref_build, n_replicas=1, ckpt_dir=ckpt,
                              hedge=r_replica.HedgePolicy(enabled=False)) as rs:
        for name, k, kw in _tenant_args(r_fid, r_optics, r_atomic):
            rs.add_tenant(name, k, **kw)
    got = load_tenant_manifest(ckpt)
    _assert_specs_equal(got, r_replica.load_tenant_manifest(ckpt))
    assert isinstance(got["t1"].fidelity.stages[0], fid.Stage)
    assert got["t1"].fidelity.fingerprint() == fid.physical().fingerprint()
    assert got["t1"].slm == optics.SLMConfig(bits=6)
    assert got["t1"].atoms == atomic.AtomicConfig(t2_s=2e-3, ihb_profile="lorentzian")


def test_port_tenant_manifest_loads_through_reference(tmp_path):
    ckpt = str(tmp_path / "manifest")
    with ReplicaSet(_port_build, n_replicas=1, ckpt_dir=ckpt,
                    hedge=HedgePolicy(enabled=False)) as rs:
        for name, k, kw in _tenant_args(fid, optics, atomic):
            rs.add_tenant(name, k, **kw)
    got = r_replica.load_tenant_manifest(ckpt)
    _assert_specs_equal(load_tenant_manifest(ckpt), got)
    assert got["t1"].fidelity.fingerprint() == r_fid.physical().fingerprint()
    # the port's manifest entries are the reference's, key for key
    for name, spec in load_tenant_manifest(ckpt).items():
        if spec.fidelity is not None:
            assert t_replica._fidelity_to_json(spec.fidelity) == r_replica._fidelity_to_json(
                got[name].fidelity
            )


def test_replica_set_search_matches_reference():
    """The same numpy clips through both packages' replica sets: scores
    within relative L2 1e-5, peak frames equal outside the reference's
    near-ties (top-two scores within 1e-5)."""
    outs = {}
    for tag, cls, hedge, build, mods in (
        ("ref", r_replica.ReplicaSet, r_replica.HedgePolicy, _ref_build, (r_fid, r_optics, r_atomic)),
        ("port", ReplicaSet, HedgePolicy, _port_build, (fid, optics, atomic)),
    ):
        # no replica is stalled here: a detector that fires only after
        # TIMEOUT keeps a first search's compile under suite load from
        # declaring both replicas dead
        with cls(build, n_replicas=2, hedge=hedge(enabled=False),
                 suspect_after_s=TIMEOUT / 2, dead_after_s=TIMEOUT) as rs:
            for name, k, kw in _tenant_args(*mods):
                rs.add_tenant(name, k, **kw)
            outs[tag] = [rs.search(t, _clip(s, T=24)) for t in ("t0", "t1") for s in (3, 4)]
    excused = 0
    for g, w in zip(outs["port"], outs["ref"]):
        gs, ws = np.asarray(g["scores"]), np.asarray(w["scores"])
        assert gs.shape == ws.shape
        assert np.linalg.norm(gs - ws) / np.linalg.norm(ws) < 1e-5
        ts = np.asarray(w["topk_scores"])
        near = np.abs(ts[..., 0] - ts[..., 1]) <= 1e-5 * np.abs(ts[..., 0])
        excused += int(near.sum())
        np.testing.assert_array_equal(
            np.asarray(g["peak_frame"])[~near], np.asarray(w["peak_frame"])[~near]
        )
    assert excused <= 1
