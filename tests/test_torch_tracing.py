"""The port's span recorder (``repro_torch.tracing``) and the spans and
queue-wait counters at the serving path's layer boundaries, on the CPU.

Off, ``span`` hands back one shared no-op and nothing is kept; on, spans
nest by thread, carry their thread and the scheduler's batch id, and
close when a batch raises and the ladder degrades.  A pooled batch
through the scheduler shows every stage under its ``sched.batch`` span;
answers are bitwise the same with recording on and off.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import sthc_kth  # noqa: E402
from repro_torch.core import hybrid  # noqa: E402
from repro_torch.distributed.fault import ChaosInjector, ChaosRule  # noqa: E402
from repro_torch.launch.resilience import DegradationLadder, RetryPolicy  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    HybridClassifierServer,
    MicrobatchScheduler,
    VideoSearchConfig,
    VideoSearchServer,
)

TIMEOUT = 120


def _kernels(seed, O=2, kt=3):
    return np.random.RandomState(seed).randn(O, 1, 3, 4, kt).astype(np.float32)


def _clip(seed, B=1, T=20):
    return np.random.RandomState(100 + seed).rand(B, 1, 12, 12, T).astype(np.float32)


def _server(n_tenants=2):
    server = VideoSearchServer(frame_hw=(12, 12), cfg=VideoSearchConfig(device="cpu", window_frames=8))
    for i in range(n_tenants):
        server.add_tenant(f"t{i}", _kernels(i))
    return server


@pytest.fixture
def recording():
    """Recording on for the test; whatever it leaves is dropped after."""
    tracing.start()
    try:
        yield
    finally:
        tracing.stop()


def _ancestors(spans, sp):
    by_id = {s[1]: s for s in spans}
    out, p = [], by_id.get(sp[2])
    while p is not None:
        out.append(p[0])
        p = by_id.get(p[2])
    return out


# -- the recorder ---------------------------------------------------------------


def test_off_returns_one_shared_no_op_and_keeps_nothing():
    assert not tracing.recording()
    a, b = tracing.span("serve.fetch"), tracing.span("engine.chunk")
    assert a is b is tracing.NO_SPAN
    with a as sp:
        sp.note("batch", 3)
    tracing.record("sched.queue", 0, 1, request=1, batch=1)
    assert tracing.stop() == []


def test_nesting_threads_and_notes(recording):
    with tracing.span("outer") as outer:
        with tracing.span("inner"):
            pass
        outer.note("batch", 7)
    seen = {}

    def other():
        with tracing.span("elsewhere"):
            seen["tid"] = threading.get_ident()

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    tracing.record("sched.queue", 10, 20, request=4, batch=7)
    spans = {s[0]: s for s in tracing.stop()}
    assert spans["inner"][2] == spans["outer"][1]
    assert spans["outer"][2] is None and spans["outer"][6] == {"batch": 7}
    assert spans["outer"][4] <= spans["inner"][4] <= spans["inner"][5] <= spans["outer"][5]
    assert spans["outer"][3] == threading.get_ident()
    assert spans["elsewhere"][3] == seen["tid"] != spans["outer"][3]
    assert spans["elsewhere"][2] is None  # the other thread's stack is its own
    assert spans["sched.queue"][4:] == (10, 20, {"request": 4, "batch": 7})


def test_a_span_open_across_stop_is_dropped():
    tracing.start()
    with tracing.span("straddles"):
        with tracing.span("closed"):
            pass
        got = tracing.stop()
    assert [s[0] for s in got] == ["closed"]
    assert tracing.stop() == []


def test_runtime_counters_are_empty_off_the_card():
    assert tracing.runtime_counters("cpu") == {}


# -- the serving path's spans -------------------------------------------------------


def test_pooled_batch_spans_nest_under_the_batcher_cycle(recording):
    server = _server(2)
    with MicrobatchScheduler(server, max_batch=4, batch_wait_s=0.2) as sched:
        futs = [sched.submit(f"t{i % 2}", _clip(i)) for i in range(4)]
        for f in futs:
            f.result(timeout=TIMEOUT)
    spans = tracing.stop()
    cycles = [s for s in spans if s[0] == "sched.batch"]
    assert cycles and all(s[6] and "batch" in s[6] for s in cycles)
    batch_of = {s[1]: s[6]["batch"] for s in cycles}
    by_id = {x[1]: x for x in spans}
    under: dict[int, set] = {}
    for s in spans:
        p = by_id.get(s[2])
        while p is not None and p[0] != "sched.batch":
            p = by_id.get(p[2])
        if p is not None:
            under.setdefault(p[1], set()).add(s[0])
    want = {"sched.form", "serve.prepare", "serve.fetch", "engine.layout", "engine.encode",
            "engine.chunk", "engine.readout", "stmul.rfftn", "stmul.mac", "stmul.irfftn",
            "serve.readback", "serve.assemble", "sched.deliver"}
    assert any(want <= names for names in under.values()), under
    queue = [s for s in spans if s[0] == "sched.queue"]
    assert sorted(s[6]["request"] for s in queue) == [1, 2, 3, 4]
    assert {s[6]["batch"] for s in queue} <= set(batch_of.values())
    assert all(s[4] <= s[5] for s in spans)
    mac = next(s for s in spans if s[0] == "stmul.mac")
    assert _ancestors(spans, mac) == ["engine.chunk", "sched.batch"]


def test_spans_close_when_a_batch_raises_and_the_ladder_degrades(recording):
    """The pooled rung fails inside ``serve.prepare`` (the ``encode``
    seam), the breaker trips, and the sequential rung serves the batch:
    the raising stage and every cycle still close."""
    server = _server(2)
    server.chaos = ChaosInjector([ChaosRule("encode", "raise", rate=1.0, mode="pooled")], seed=1)
    with MicrobatchScheduler(
        server, max_queue=8, max_batch=1, batch_wait_s=0.0,
        retry=RetryPolicy(max_retries=0),
        ladder=DegradationLadder(failure_threshold=1, recovery_s=60.0),
    ) as sched:
        outs = [sched.submit(f"t{i % 2}", _clip(i)).result(timeout=TIMEOUT) for i in range(3)]
        assert sched.metrics()["mode"] == "sequential"
    assert all(np.isfinite(o["scores"]).all() for o in outs)
    spans = tracing.stop()
    names = [s[0] for s in spans]
    assert names.count("sched.batch") == 3 and names.count("sched.deliver") == 3
    prepares = [s for s in spans if s[0] == "serve.prepare"]
    # the failed pooled attempt and each sequential call, all inside a cycle
    assert len(prepares) == 4
    assert all(_ancestors(spans, s) == ["sched.batch"] for s in prepares)
    assert names.count("serve.fetch") == 3 and names.count("serve.readback") == 3
    assert all(s[4] <= s[5] for s in spans)


def test_queue_wait_counts_the_wait_behind_a_slow_batch():
    server = _server(2)
    delay = 0.1
    orig = server.search_batch

    def slow(reqs, pooled=None, **kw):
        time.sleep(delay)
        return orig(reqs, pooled=pooled, **kw)

    server.search_batch = slow
    with MicrobatchScheduler(server, max_batch=1, batch_wait_s=0.0) as sched:
        futs = [sched.submit(f"t{i % 2}", _clip(i)) for i in range(4)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        m = sched.metrics()
    assert m["dequeued"] == 4 and m["batches"] == 4
    # the waits are ~0, d, 2d, 3d (plus compute): their mean is past d
    assert m["queue_wait_ns"] / m["dequeued"] >= delay * 1e9


def test_search_answers_are_bitwise_with_recording_on_and_off():
    reqs = [("t0", _clip(1)), ("t1", _clip(2)), ("t0", _clip(3, T=28))]
    outs = []
    for on in (False, True):
        server = _server(2)
        if on:
            tracing.start()
        try:
            outs.append(server.search_batch(reqs))
        finally:
            spans = tracing.stop()
        assert bool(spans) == on
    for a, b in zip(*outs):
        assert np.array_equal(a["scores"], b["scores"])
        assert np.array_equal(a["peak_frame"], b["peak_frame"])


def test_classifier_answers_are_bitwise_with_recording_on_and_off():
    cfg = sthc_kth.smoke_config()
    gen = torch.Generator().manual_seed(0)
    server = HybridClassifierServer(hybrid.init_params(cfg, gen, device="cpu"), cfg, device="cpu")
    rng = np.random.RandomState(5)
    clips = rng.rand(3, cfg.in_channels, cfg.height, cfg.width, cfg.frames).astype(np.float32)
    streams = rng.rand(2, cfg.in_channels, cfg.height, cfg.width, 3 * cfg.frames).astype(np.float32)
    off = (server.classify(clips), server.classify_stream(streams))
    tracing.start()
    try:
        on = (server.classify(clips), server.classify_stream(streams))
    finally:
        spans = tracing.stop()
    assert np.array_equal(off[0], on[0]) and np.array_equal(off[1], on[1])
    names = {s[0] for s in spans}
    assert {"classify.upload", "classify.correlate", "classify.head", "classify.readback",
            "sthc.record", "engine.chunk", "engine.stitch", "stmul.mac"} <= names
