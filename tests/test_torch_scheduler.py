"""The port's microbatch scheduler, degradation ladder, chaos seams and
chaos injector, against the reference and inside the port.

Mirrors the scheduler tests of ``tests/test_serve.py``, the scheduler,
quarantine and chaos tests of ``tests/test_resilience.py`` and the two
scheduler race smokes of ``tests/test_race_smoke.py`` on the port
(``device="cpu"``, the plain torch versions of the kernels), at the
reference tests' geometry: 12x12 frames, 8-frame windows, kernels
(2, 1, 3, 4, 3).  Parity with the reference: the same numpy requests
through both schedulers give scores within relative L2 1e-5 and equal
peak frames outside ties; the same chaos rules and seed fire at the same
events and poison the same row in both packages; the threaded
``clip_keys_for`` gives the serial keys bitwise, and the reference's
``clip_key`` digest.  Every ``result()`` waits up to 60 s or more; the
breaker and backoff schedules run on a fake clock where the reference's
tests use one.
"""

import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

from repro.core import engine as r_engine  # noqa: E402
from repro.core import fidelity as r_fid  # noqa: E402
from repro.distributed import fault as r_fault  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import fidelity as fid  # noqa: E402
from repro_torch.core.engine import GratingCache  # noqa: E402
from repro_torch.core.sthc import STHC, STHCConfig  # noqa: E402
from repro_torch.distributed.fault import ChaosInjector, ChaosRule, InjectedFault  # noqa: E402
from repro_torch.launch.resilience import (  # noqa: E402
    DeadlineExceeded,
    DegradationLadder,
    RequestRejected,
    RetryPolicy,
    SchedulerClosed,
    ServingError,
    TenantQuarantined,
)
from repro_torch.launch.serve import (  # noqa: E402
    MicrobatchScheduler,
    VideoSearchConfig,
    VideoSearchServer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_THREADS = 8
TIMEOUT = 120  # seconds any result() may wait


def _kernels(seed, O=2, kt=3):
    rng = np.random.RandomState(seed)
    return rng.randn(O, 1, 3, 4, kt).astype(np.float32)


def _clip(seed, B=1, T=20, H=12, W=12):
    rng = np.random.RandomState(100 + seed)
    return rng.rand(B, 1, H, W, T).astype(np.float32)


def _cfg(**kw):
    kw.setdefault("window_frames", 8)
    return VideoSearchConfig(device="cpu", **kw)


def _server(n_tenants=2, **cfg_kw):
    server = VideoSearchServer(frame_hw=(12, 12), cfg=_cfg(**cfg_kw))
    for i in range(n_tenants):
        server.add_tenant(f"t{i}", _kernels(i))
    return server


def _delayed(server, seconds):
    """Wrap ``server.search_batch`` so each call first sleeps ``seconds``."""
    orig = server.search_batch

    def slow(reqs, pooled=None, **kw):
        time.sleep(seconds)
        return orig(reqs, pooled=pooled, **kw)

    server.search_batch = slow


def _gated(server):
    """Wrap ``server.search_batch`` so each call waits for the returned
    event (at most 30 s) before it runs."""
    orig = server.search_batch
    release = threading.Event()

    def gated(reqs, pooled=None, **kw):
        release.wait(timeout=30)
        return orig(reqs, pooled=pooled, **kw)

    server.search_batch = gated
    return release


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# -- microbatch scheduler (tests/test_serve.py) ------------------------------


def test_scheduler_batches_and_matches_search_batch():
    server = VideoSearchServer(frame_hw=(12, 12), cfg=_cfg(chunk_windows=2))
    server.add_tenant("a", _kernels(0)).add_tenant("b", _kernels(1))
    reqs = [("a", _clip(1)), ("b", _clip(2)), ("a", _clip(3))]
    want = server.search_batch(reqs)
    with MicrobatchScheduler(server, max_queue=8, max_batch=4, batch_wait_s=0.05) as sched:
        futs = [sched.submit(t, c) for t, c in reqs]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        m = sched.metrics()
    for out, ref in zip(outs, want):
        assert out["tenant"] == ref["tenant"]
        np.testing.assert_allclose(out["scores"], ref["scores"], rtol=1e-4)
        assert out["queue_latency_s"] > 0
    assert m["submitted"] == 3 and m["completed"] == 3
    assert m["batches"] >= 1 and m["mean_batch_size"] > 1  # coalesced
    assert m["latency_p50_ms"] > 0
    assert m["latency_p99_ms"] >= m["latency_p50_ms"]


def test_scheduler_sheds_on_full_queue():
    server = _server(1)
    _delayed(server, 0.25)  # hold the batcher busy so the queue fills
    with MicrobatchScheduler(server, max_queue=1, max_batch=1, batch_wait_s=0.0) as sched:
        futs, shed = [], 0
        for i in range(8):
            try:
                futs.append(sched.submit("t0", _clip(i)))
            except RequestRejected:
                shed += 1
        assert shed > 0
        assert sched.metrics()["rejected"] == shed
        for f in futs:
            f.result(timeout=TIMEOUT)  # admitted requests still complete
    assert sched.metrics()["completed"] == len(futs)


def test_scheduler_bad_request_fails_only_its_future():
    server = _server(1)
    with MicrobatchScheduler(server, max_queue=8, max_batch=4, batch_wait_s=0.05) as sched:
        good = sched.submit("t0", _clip(0))
        bad = sched.submit("nope", _clip(1))
        good2 = sched.submit("t0", _clip(2))
        with pytest.raises(KeyError, match="unknown tenant"):
            bad.result(timeout=TIMEOUT)
        assert good.result(timeout=TIMEOUT)["scores"].shape == (1, 2)
        assert good2.result(timeout=TIMEOUT)["scores"].shape == (1, 2)
    assert sched.metrics()["failed"] == 1


def test_scheduler_close_fails_pending_futures():
    server = _server(1)
    _delayed(server, 0.3)
    sched = MicrobatchScheduler(server, max_queue=8, max_batch=1, batch_wait_s=0.0)
    futs = [sched.submit("t0", _clip(i)) for i in range(4)]
    sched.close()
    with pytest.raises(RuntimeError):
        sched.submit("t0", _clip(9))
    assert all(f.done() for f in futs)  # resolved or failed, not hung


def test_scheduler_mixed_shapes_all_complete_and_coalesce():
    server = VideoSearchServer(frame_hw=(12, 12), cfg=_cfg(chunk_windows=2))
    server.add_tenant("a", _kernels(0)).add_tenant("b", _kernels(1))
    with MicrobatchScheduler(server, max_queue=32, max_batch=4, batch_wait_s=0.1) as sched:
        futs = []
        for i in range(4):  # alternate two stream lengths (shapes)
            futs.append(sched.submit("a", _clip(i, T=20)))
            futs.append(sched.submit("b", _clip(i, T=24)))
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        m = sched.metrics()
    assert all(o["scores"].shape == (1, 2) for o in outs)
    assert m["completed"] == 8
    assert m["batches"] <= 6


def test_scheduler_forms_dedup_groups_and_counts():
    server = _server(3)
    clip = _clip(4, T=24)
    with MicrobatchScheduler(server, max_queue=8, max_batch=8, batch_wait_s=0.05) as sched:
        futs = [sched.submit(f"t{i}", clip, block=True) for i in range(3)]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    for out, i in zip(outs, range(3)):
        assert out["tenant"] == f"t{i}"
    m = sched.metrics()
    assert m["completed"] == 3
    assert m["dedup_grouped"] >= 2
    assert server.metrics()["dedup"]["rows_saved"] >= 2


def test_scheduler_cancel_mid_dedup_group_does_not_poison_siblings():
    server = _server(3)
    clip = _clip(5, T=24)
    ref = {f"t{i}": server.search(clip, tenant=f"t{i}")["scores"] for i in range(3)}
    release = _gated(server)
    with MicrobatchScheduler(server, max_queue=8, max_batch=1, batch_wait_s=0.0) as sched:
        # batch 1 occupies the batcher behind the gate; the three
        # same-clip requests queue up as the next dedup group
        blocker = sched.submit("t0", _clip(6, T=24))
        time.sleep(0.05)
        futs = [sched.submit(f"t{i}", clip) for i in range(3)]
        assert futs[1].cancel()  # cancel a dedup-group member pre-dispatch
        release.set()
        assert futs[0].result(timeout=TIMEOUT)["tenant"] == "t0"
        assert futs[2].result(timeout=TIMEOUT)["tenant"] == "t2"
        np.testing.assert_allclose(futs[0].result()["scores"], ref["t0"], rtol=1e-5)
        np.testing.assert_allclose(futs[2].result()["scores"], ref["t2"], rtol=1e-5)
        blocker.result(timeout=TIMEOUT)
        with pytest.raises(Exception):  # cancelled future never resolves
            futs[1].result(timeout=5)
        again = sched.submit("t1", clip, block=True)
        np.testing.assert_allclose(again.result(timeout=TIMEOUT)["scores"], ref["t1"], rtol=1e-5)
    assert sched.metrics()["completed"] >= 4


def test_scheduler_close_fails_queued_dedup_group():
    server = _server(1)
    release = _gated(server)
    sched = MicrobatchScheduler(server, max_queue=8, max_batch=1, batch_wait_s=0.0)
    blocker = sched.submit("t0", _clip(7, T=24))
    time.sleep(0.05)
    clip = _clip(8, T=24)
    group = [sched.submit("t0", clip) for _ in range(3)]
    closer = threading.Thread(target=sched.close)
    closer.start()
    time.sleep(0.05)
    release.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    for f in [blocker] + group:
        assert f.done()  # resolved or failed, never hung
    # the group queued behind the gate: close() resolves every member
    for f in group:
        with pytest.raises(SchedulerClosed):
            f.result(timeout=0)


# -- scheduler lifecycle (tests/test_resilience.py) --------------------------


def test_scheduler_deadline_exceeded_is_typed():
    server = _server(1)
    release = _gated(server)
    with MicrobatchScheduler(
        server, max_queue=8, max_batch=1, batch_wait_s=0.0, watchdog_interval_s=0.005,
    ) as sched:
        wedger = sched.submit("t0", _clip(0))
        doomed = sched.submit("t0", _clip(1), deadline_s=0.05)
        with pytest.raises(DeadlineExceeded) as ei:
            doomed.result(timeout=TIMEOUT)
        assert ei.value.tenant == "t0"
        release.set()
        wedger.result(timeout=TIMEOUT)  # the wedged request still completes
        m = sched.metrics()
    assert m["deadline_missed"] >= 1 and m["watchdog_expired"] >= 1
    assert m["failed"] >= 1


def test_scheduler_default_deadline_applies():
    server = _server(1)
    release = threading.Event()
    server.search_batch = lambda reqs, pooled=None, **kw: release.wait(5)
    with MicrobatchScheduler(
        server, max_queue=4, max_batch=1, batch_wait_s=0.0,
        default_deadline_s=0.05, watchdog_interval_s=0.005,
    ) as sched:
        fut = sched.submit("t0", _clip(0))
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=TIMEOUT)
        release.set()  # let the wedged dispatch end before close() joins


def test_scheduler_close_resolves_queued_futures():
    server = _server(1)
    started = threading.Event()
    release = threading.Event()

    def wedged(reqs, pooled=None, **kw):
        started.set()
        release.wait(timeout=10.0)
        raise InjectedFault("dispatch")  # the in-flight one fails too

    server.search_batch = wedged
    sched = MicrobatchScheduler(
        server, max_queue=8, max_batch=1, batch_wait_s=0.0, retry=RetryPolicy(max_retries=0),
    )
    inflight = sched.submit("t0", _clip(0))
    assert started.wait(timeout=10)
    queued = [sched.submit("t0", _clip(i)) for i in range(1, 4)]
    closer = threading.Thread(target=sched.close)
    closer.start()
    release.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    for f in queued:
        with pytest.raises(SchedulerClosed):
            f.result(timeout=0)
    with pytest.raises(ServingError):
        inflight.result(timeout=0)
    with pytest.raises(SchedulerClosed):
        sched.submit("t0", _clip(9))
    sched.close()  # idempotent


def test_scheduler_retries_transient_fault_then_succeeds():
    server = _server(1)
    orig = server.search_batch
    fails = {"n": 2}

    def flaky(reqs, pooled=None, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise InjectedFault("dispatch", "flaky")
        return orig(reqs, pooled=pooled, **kw)

    server.search_batch = flaky
    with MicrobatchScheduler(
        server, max_queue=4, max_batch=1, batch_wait_s=0.0,
        retry=RetryPolicy(max_retries=4, base_s=1e-4, cap_s=1e-3, seed=0),
        ladder=DegradationLadder(failure_threshold=5),
    ) as sched:
        out = sched.submit("t0", _clip(0)).result(timeout=TIMEOUT)
        m = sched.metrics()
    assert np.isfinite(out["scores"]).all()
    assert m["retries"] == 2 and m["completed"] == 1 and m["failed"] == 0
    assert m["mode"] == "pooled"


def test_scheduler_degrades_to_sequential_when_pooled_path_fails():
    server = _server(2)
    orig = server.search_batch

    def pooled_down(reqs, pooled=None, **kw):
        if pooled is not False:  # the pooled rung passes pooled=None
            raise InjectedFault("dispatch", "pooled path down")
        return orig(reqs, pooled=False, **kw)

    server.search_batch = pooled_down
    with MicrobatchScheduler(
        server, max_queue=8, max_batch=4, batch_wait_s=0.01,
        retry=RetryPolicy(max_retries=0),
        ladder=DegradationLadder(failure_threshold=1, recovery_s=60.0),
    ) as sched:
        outs = [sched.submit(f"t{i % 2}", _clip(i)).result(timeout=TIMEOUT) for i in range(3)]
        m = sched.metrics()
    for out in outs:
        assert np.isfinite(out["scores"]).all()
    assert m["completed"] == 3 and m["failed"] == 0
    assert m["mode"] == "sequential"
    assert m["ladder"]["breakers"]["pooled"]["trips"] >= 1


def test_chaos_seam_breaker_degrades_and_recovers_on_fake_clock():
    """The pooled dispatch seam at rate 1 trips the breaker (the ladder's
    clock is fake): the next requests are served on the sequential rung,
    within 1e-5 of the pooled rung's answers; with the rule removed and
    the clock past ``recovery_s`` the half-open probe closes it."""
    server = _server(2)
    reqs = [("t0", _clip(0)), ("t1", _clip(1))]
    want = [server.search_batch([r])[0] for r in reqs]
    clock = _FakeClock()
    ladder = DegradationLadder(failure_threshold=2, recovery_s=1.0, clock=clock)
    chaos = ChaosInjector([ChaosRule("dispatch", "raise", rate=1.0, mode="pooled")], seed=1)
    server.chaos = chaos
    with MicrobatchScheduler(
        server, max_batch=1, batch_wait_s=0.0,
        retry=RetryPolicy(max_retries=1, base_s=1e-4, cap_s=1e-3, seed=0), ladder=ladder,
    ) as sched:
        got = [sched.submit(t, c).result(timeout=TIMEOUT) for t, c in reqs]
        assert sched.metrics()["mode"] == "sequential"
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-5)
        assert server.metrics()["sequential_dispatches"] == 2
        chaos.rules.clear()
        clock.t += 1.5
        sched.submit(*reqs[0]).result(timeout=TIMEOUT)
        m = sched.metrics()
    snap = m["ladder"]["breakers"]["pooled"]
    assert m["mode"] == "pooled" and snap["trips"] == 1 and snap["recoveries"] == 1
    assert chaos.stats()["injected"]["dispatch/raise"] == 2  # the first try and its retry


def test_scheduler_validation_error_passes_through_unwrapped():
    server = _server(1)
    with MicrobatchScheduler(server, max_queue=4, max_batch=2, batch_wait_s=0.01) as sched:
        bad = sched.submit("nope", _clip(0))
        with pytest.raises(KeyError, match="unknown tenant"):
            bad.result(timeout=TIMEOUT)
        m = sched.metrics()
    assert m["failed"] == 1 and m["retries"] == 0
    assert m["ladder"]["breakers"]["pooled"]["trips"] == 0


# -- signal integrity: quarantine + cache checksum ---------------------------


def test_quarantine_isolates_poisoned_row_bitwise():
    server = _server(4)
    healthy = [("t0", _clip(0)), ("t1", _clip(1)), ("t2", _clip(2))]
    clean4 = _clip(3)
    poisoned4 = clean4.copy()
    poisoned4[0, 0, 0, 0, :] = np.nan
    ref = server.search_batch(healthy + [("t3", clean4)])
    out = server.search_batch(healthy + [("t3", poisoned4)])
    for r, o in zip(ref[:3], out[:3]):
        assert np.array_equal(r["scores"], o["scores"])
    assert isinstance(out[3], TenantQuarantined)
    assert out[3].tenant == "t3"
    assert server.metrics()["quarantined"] == 1
    with pytest.raises(TenantQuarantined):
        server.search(poisoned4, tenant="t3")


def test_scheduler_routes_quarantine_into_the_one_future():
    server = _server(2)
    bad = _clip(0)
    bad[0, 0, 0, 0, :] = np.nan
    with MicrobatchScheduler(server, max_queue=8, max_batch=4, batch_wait_s=0.05) as sched:
        good = sched.submit("t0", _clip(1))
        doomed = sched.submit("t1", bad)
        assert np.isfinite(good.result(timeout=TIMEOUT)["scores"]).all()
        with pytest.raises(TenantQuarantined) as ei:
            doomed.result(timeout=TIMEOUT)
        assert ei.value.tenant == "t1"
        m = sched.metrics()
    assert m["quarantined"] == 1 and m["completed"] == 1


def test_guard_scores_off_restores_raw_delivery():
    server = _server(1, guard_scores=False)
    bad = _clip(0)
    bad[0, 0, 0, 0, :] = np.nan
    out = server.search_batch([("t0", bad)])[0]
    assert isinstance(out, dict)  # no quarantine: raw NaNs delivered
    assert not np.isfinite(out["scores"]).all()


def test_cache_verify_detects_corruption_and_self_heals():
    cache = GratingCache(max_entries=4, verify=True)
    sthc = STHC(STHCConfig(fidelity=fid.ideal(), device="cpu"), cache=cache)
    sthc.record(_kernels(0), (12, 12, 8))
    key = next(iter(cache._entries))
    entry = cache._entries[key]
    # bit-rot stand-in: NaN-poison the resident storage plane in place
    if entry.effective is not None:
        entry.effective = entry.effective * float("nan")
    else:
        entry.eff_re = entry.eff_re * float("nan")
    g2 = sthc.record(_kernels(0), (12, 12, 8))  # fetch -> detect -> heal
    assert cache.stats()["integrity_failures"] == 1
    assert cache.stats()["misses"] == 2  # the self-heal re-record
    re, im = g2.planes
    assert bool(torch.isfinite(re).all()) and bool(torch.isfinite(im).all())
    assert cache._entries[key] is g2


def test_cache_verify_off_by_default_and_free():
    cache = GratingCache(max_entries=2)
    assert cache.stats()["verify"] is False
    assert cache.stats()["integrity_failures"] == 0


# -- chaos injector -----------------------------------------------------------


def test_chaos_injector_is_seed_deterministic():
    def run(seed):
        chaos = ChaosInjector([ChaosRule("dispatch", "raise", rate=0.3)], seed=seed)
        fired = []
        for _ in range(50):
            try:
                chaos.on("dispatch")
                fired.append(0)
            except InjectedFault:
                fired.append(1)
        return fired, chaos.stats()

    a, sa = run(seed=3)
    b, sb = run(seed=3)
    c, _ = run(seed=4)
    assert a == b and sa == sb
    assert a != c
    assert sa["events"]["dispatch"] == 50
    assert sa["injected"]["dispatch/raise"] == sum(a) == sa["total_injected"]


def test_chaos_at_indices_fire_once_and_mode_filters():
    evicted = []
    chaos = ChaosInjector(
        [
            ChaosRule("cache_fetch", "call", at=(2,), action=lambda: evicted.append(1)),
            ChaosRule("dispatch", "raise", at=(1,), mode="pooled"),
        ],
        seed=0,
    )
    for _ in range(5):
        chaos.on("cache_fetch")
    assert evicted == [1]
    chaos.on("dispatch", mode="sequential")  # event 1, wrong mode: no fire
    chaos.on("dispatch", mode="pooled")  # event 2: index 1 already passed
    assert chaos.stats()["injected"].get("dispatch/raise") is None
    with pytest.raises(ValueError):
        ChaosRule("dispatch", "explode")


def test_chaos_nan_rule_poisons_a_copy():
    chaos = ChaosInjector([ChaosRule("readout", "nan", at=(1,))], seed=0)
    peak = np.ones((3, 2), dtype=np.float32)
    out = chaos.on("readout", payload=peak)
    assert np.isfinite(peak).all()  # caller's array untouched
    assert np.isnan(out).any() and np.isnan(out).sum() == 2  # one row


# -- concurrency ----------------------------------------------------------------


def test_tenant_churn_race_leaves_no_orphan_cache_entries():
    server = VideoSearchServer(
        frame_hw=(12, 12), cfg=_cfg(cache_entries=3, verify_gratings=True)
    )
    for i in range(3):
        server.add_tenant(f"base{i}", _kernels(i))
    stop = threading.Event()
    errors = []

    def churn(tid):
        name = f"churn{tid}"
        k = 0
        while not stop.is_set():
            try:
                server.add_tenant(name, _kernels(10 + tid + k))
                server.search(_clip(tid), tenant=name)
                server.remove_tenant(name)
                k += 1
            except KeyError:
                pass
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
                return

    def searcher():
        while not stop.is_set():
            try:
                server.search(_clip(0), tenant="base0")
                server.search(_clip(1), tenant="base2")
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
                return

    threads = [threading.Thread(target=churn, args=(i,)) for i in range(2)]
    threads.append(threading.Thread(target=searcher))
    for t in threads:
        t.start()
    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors
    live_keys = {t.key for t in server._tenants.values()}
    with server.cache._lock:
        cached = set(server.cache._entries)
        sums = set(server.cache._sums)
    assert cached <= live_keys
    assert sums <= cached
    stats = server.cache.stats()
    assert stats["entries"] <= 3 and stats["bytes"] >= 0


def test_retry_delays_deadline_truncation_fake_clock():
    policy = RetryPolicy(max_retries=5, base_s=0.01, cap_s=10.0, seed=7)
    clock = _FakeClock(t=100.0)
    full = list(policy.delays())
    assert len(full) == 5
    assert list(policy.delays(deadline=1e9, clock=clock)) == full
    cutoff = 100.0 + full[0] + full[1] + 0.5 * full[2]
    clock.t = 100.0
    got = []
    for d in policy.delays(deadline=cutoff, clock=clock):
        got.append(d)
        clock.t += d  # the sleep
    assert got == full[:2]
    clock.t = 100.0
    assert list(policy.delays(deadline=99.0, clock=clock)) == []
    clock.t = 0.0
    assert list(policy.delays(deadline=full[0], clock=clock)) == []


def _race_clip(seed, T=16):
    rng = np.random.RandomState(500 + seed)
    return rng.rand(1, 1, 12, 12, T).astype(np.float32)


def test_scheduler_race_smoke_submit_vs_close():
    """8 submitter threads race a mid-flight ``close()`` with chaos latency
    on the encode and dispatch seams: every accepted future resolves,
    late submits raise SchedulerClosed, and the counters reconcile with
    what the callers saw."""
    server = VideoSearchServer(frame_hw=(12, 12), cfg=_cfg(window_frames=64))
    server.add_tenant("a", _kernels(0))
    server.add_tenant("b", _kernels(1))
    server.chaos = ChaosInjector(
        [
            ChaosRule(seam="encode", kind="latency", rate=0.5, delay_s=0.003),
            ChaosRule(seam="dispatch", kind="latency", rate=0.5, delay_s=0.003),
        ],
        seed=11,
    )
    sched = MicrobatchScheduler(server, max_queue=16, max_batch=4, batch_wait_s=0.001)
    accepted: list[Future] = []
    acc_lock = threading.Lock()
    shed = [0]
    errors = []
    barrier = threading.Barrier(N_THREADS + 1)

    def submitter(tid):
        clips = [_race_clip(tid), _race_clip(100 + tid)]
        barrier.wait()
        try:
            for step in range(12):
                tenant = "a" if (tid + step) % 2 == 0 else "b"
                try:
                    fut = sched.submit(tenant, clips[step % 2], block=False)
                except SchedulerClosed:
                    return
                except RequestRejected:
                    with acc_lock:
                        shed[0] += 1
                    continue
                with acc_lock:
                    accepted.append(fut)
        except Exception as e:  # pragma: no cover - failure path
            errors.append((tid, e))

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(N_THREADS)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        barrier.wait()
        threading.Event().wait(0.05)
        sched.close()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive(), "submitter thread hung"
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    completed = failed = 0
    for fut in accepted:
        assert fut.done(), "future left hanging across close()"
        exc = fut.exception(timeout=0)
        if exc is None:
            assert fut.result(timeout=0)["tenant"] in ("a", "b")
            completed += 1
        else:
            assert isinstance(exc, ServingError), exc
            failed += 1
    m = sched.metrics()
    assert m["submitted"] == len(accepted)
    assert m["rejected"] == shed[0]
    assert completed + failed == len(accepted)
    assert m["completed"] == completed
    assert m["failed"] == failed
    with pytest.raises(ServingError):
        sched.submit("a", _race_clip(999), block=False)


def test_scheduler_race_smoke_clean_drain():
    server = VideoSearchServer(frame_hw=(12, 12), cfg=_cfg(window_frames=64))
    server.add_tenant("a", _kernels(2))
    server.chaos = ChaosInjector(
        [ChaosRule(seam="cache_fetch", kind="latency", rate=0.3, delay_s=0.002)], seed=3,
    )
    futures = []
    flock = threading.Lock()
    shed = [0]
    with MicrobatchScheduler(server, max_queue=64, max_batch=4, batch_wait_s=0.001) as sched:
        barrier = threading.Barrier(N_THREADS)

        def submitter(tid):
            clip = _race_clip(tid)
            barrier.wait()
            for _ in range(6):
                try:
                    fut = sched.submit("a", clip, block=True)
                except ServingError:
                    with flock:
                        shed[0] += 1
                    continue
                with flock:
                    futures.append(fut)

        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        for fut in futures:
            assert fut.result(timeout=TIMEOUT)["tenant"] == "a"
    m = sched.metrics()
    assert m["submitted"] == len(futures) == N_THREADS * 6 - shed[0]
    assert m["completed"] == len(futures)
    assert m["failed"] == 0
    assert m["batches"] <= m["completed"]
    assert server.chaos.stats()["events"]["cache_fetch"] >= m["batches"]


# -- parity with the reference --------------------------------------------------

TENANTS = [("alpha", "ideal"), ("beta", "physical"), ("gamma", "slm_quantize")]


def _pipe(mod, name):
    return {
        "ideal": mod.ideal,
        "physical": mod.physical,
        "slm_quantize": lambda: mod.pipeline(mod.SLMQuantize()),
    }[name]()


def _pair(**kw):
    """The reference's and the port's server with the same tenants."""
    kw = dict(window_frames=8, chunk_windows=2, **kw)
    ref = r_serve.VideoSearchServer(frame_hw=(12, 12), cfg=r_serve.VideoSearchConfig(use_pallas=True, **kw))
    port = VideoSearchServer(frame_hw=(12, 12), cfg=_cfg(**kw))
    for i, (name, pipe) in enumerate(TENANTS):
        ref.add_tenant(name, _kernels(i), fidelity=_pipe(r_fid, pipe))
        port.add_tenant(name, _kernels(i), fidelity=_pipe(fid, pipe))
    return ref, port


def _requests():
    shared = _clip(20)
    return [
        ("alpha", _clip(21)), ("beta", shared), ("gamma", shared),
        ("alpha", _clip(22, B=2)), ("beta", _clip(23)), ("gamma", _clip(24, T=20)),
    ]


def test_scheduler_matches_reference_scheduler():
    ref, port = _pair(readout_topk=2)
    reqs = _requests()
    outs = {}
    for name, mod, server in (("ref", r_serve, ref), ("port", None, port)):
        cls = r_serve.MicrobatchScheduler if mod else MicrobatchScheduler
        with cls(server, max_queue=16, max_batch=8, batch_wait_s=0.05) as sched:
            futs = [sched.submit(t, c, block=True) for t, c in reqs]
            outs[name] = [f.result(timeout=TIMEOUT) for f in futs]
            m = sched.metrics()
        outs[name + "_m"] = m
    excused = 0
    for g, w in zip(outs["port"], outs["ref"]):
        assert g["tenant"] == w["tenant"] and g["windows"] == w["windows"]
        assert g["scores"].shape == w["scores"].shape
        assert rel_l2(g["scores"], w["scores"]) < 1e-5
        ts = np.asarray(w["topk_scores"])
        near = np.abs(ts[..., 0] - ts[..., 1]) <= 1e-5 * np.abs(ts[..., 0])
        excused += int(near.sum())
        assert np.array_equal(np.asarray(g["peak_frame"])[~near], np.asarray(w["peak_frame"])[~near])
    assert excused <= 1
    for k in ("submitted", "completed", "failed", "rejected"):
        assert outs["port_m"][k] == outs["ref_m"][k]
    # the port's queue-wait counters are its own additions
    assert set(outs["port_m"]) == set(outs["ref_m"]) | {"dequeued", "queue_wait_ns"}
    assert outs["port_m"]["dequeued"] == len(reqs)


RULES = [
    ("dispatch", "raise", 0.3, (), None),
    ("dispatch", "latency", 0.2, (3,), "pooled"),
    ("cache_fetch", "call", 0.25, (), None),
    ("encode", "latency", 0.1, (2, 5), None),
    ("readout", "nan", 0.4, (), None),
]


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_chaos_injector_matches_reference(seed):
    """The same rules and seed fire at the same events, poison the same
    rows and count the same in both packages."""

    def run(mod):
        calls = []
        rules = [
            mod.ChaosRule(s, k, rate=r, at=at, mode=m, delay_s=0.0,
                          action=(lambda: calls.append(1)) if k == "call" else None)
            for s, k, r, at, m in RULES
        ]
        chaos = mod.ChaosInjector(rules, seed=seed)
        trace = []
        for i in range(40):
            seam = ("dispatch", "cache_fetch", "encode", "readout")[i % 4]
            mode = "pooled" if i % 3 else "sequential"
            payload = np.ones((5, 2), np.float32) if seam == "readout" else None
            try:
                out = chaos.on(seam, mode=mode, payload=payload)
            except mod.InjectedFault as exc:
                trace.append(("raise", exc.seam))
                continue
            if out is not None:
                trace.append(("rows", tuple(np.flatnonzero(np.isnan(out).any(axis=1)))))
        return trace, chaos.stats(), len(calls)

    assert run(r_fault) == run(sys.modules[ChaosInjector.__module__])


@pytest.mark.parametrize("pooled", [True, False])
def test_seams_fire_where_the_reference_fires_them(pooled):
    """A readout ``nan`` rule and an ``at`` rule on every other seam: the
    port's server fires the same seam events as the reference's in the
    same order, and the poisoned request quarantines in both."""

    def run(mod, server):
        order = []
        rules = [
            mod.ChaosRule(s, "call", at=(1, 2, 3), action=lambda s=s: order.append(s))
            for s in ("cache_fetch", "encode", "dispatch")
        ] + [mod.ChaosRule("readout", "nan", at=(2,))]
        server.chaos = mod.ChaosInjector(rules, seed=4)
        out = server.search_batch(_requests(), pooled=pooled)
        return order, server.chaos.stats(), [isinstance(o, Exception) for o in out]

    ref, port = _pair()
    want = run(r_fault, ref)
    got = run(sys.modules[ChaosInjector.__module__], port)
    assert got == want
    assert sum(got[2]) == 1  # one request quarantined


def test_clip_keys_threaded_match_serial_and_reference():
    clips = [_clip(i, B=1 + i % 2, T=16 + i) for i in range(5)]
    arrays = [clips[0], clips[1], clips[0], clips[2], clips[3], clips[4], clips[1]]
    serial = [t_engine.clip_key(x) for x in arrays]
    threaded = t_engine.clip_keys_for(arrays)
    assert threaded == serial
    assert threaded[0] is threaded[2]  # one digest per distinct object
    for x, k in zip(arrays, threaded):
        assert k == r_engine.clip_key(x)
    # a tensor hashes as its bytes do; a strided view as its copy
    assert t_engine.clip_keys_for([torch.from_numpy(clips[3])]) == [serial[4]]
    view = np.ascontiguousarray(clips[4])[..., ::2]
    assert t_engine.clip_key(view) == r_engine.clip_key(np.ascontiguousarray(view))
    assert t_engine.clip_keys_for([clips[0]]) == [serial[0]]
    assert t_engine.clip_keys_for([]) == []


def test_submit_hashes_in_the_callers_thread_and_batch_reuses_keys(monkeypatch):
    """The scheduler hashes each clip once, at submit, in the submitting
    thread; the batch's dispatch reads those keys (no second digest)."""
    server = _server(2)
    seen = []
    orig = t_engine.clip_key

    def spy(x):
        seen.append(threading.current_thread().name)
        return orig(x)

    import repro_torch.launch.serve as t_serve_mod

    monkeypatch.setattr(t_serve_mod, "clip_key", spy)
    monkeypatch.setattr(t_engine, "clip_key", spy)
    clip = _clip(3)
    with MicrobatchScheduler(server, max_queue=8, max_batch=4, batch_wait_s=0.05) as sched:
        futs = [sched.submit("t0", clip), sched.submit("t1", clip)]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        m = sched.metrics()
    assert seen == [threading.current_thread().name] * 2
    assert m["dedup_grouped"] == 1 and [o["tenant"] for o in outs] == ["t0", "t1"]


def test_example_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "serve_video_torch.py"), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "running segment (frames 12-23): peak" in proc.stdout and "-> OK" in proc.stdout
    assert "scheduler: 2 served in" in proc.stdout
