"""The port's query engine and STHC against the JAX reference: record and
query under ideal, physical, SLM-quantize-only and bf16 storage; the
unfused reference path; overlap-save streaming, chunked and unbounded;
the pooled executor with clip-dedup and the fused top-K readout; the
grating cache; and query parity on a reference-recorded grating carried
across with ``interop.fused_grating_from_numpy``.

Both packages run ``use_pallas=True``: the reference's Pallas kernels in
interpret mode, the port's wrappers on their plain torch versions (CPU
tensors).  Tolerances: relative L2 <= 1e-5 for f32 volumes and scores,
<= 1e-3 with bf16 grating storage; peak indices exact except where the
reference's own two best scores lie within 1e-5 relative (counted).
Inside the port the invariants are bitwise.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests elsewhere must not starve
torch.set_num_threads(1)
# full float32 in any matmul / convolution a test reaches (cuDNN defaults to TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from repro.core import fidelity as r_fid  # noqa: E402
from repro.core.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.core.sthc import STHC as RSTHC  # noqa: E402
from repro.core.sthc import STHCConfig as RConfig  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import fidelity as t_fid  # noqa: E402
from repro_torch.core.engine import GratingCache, QueryEngine  # noqa: E402
from repro_torch.core.sthc import STHC, STHCConfig  # noqa: E402
from repro_torch.interop import fused_grating_from_numpy  # noqa: E402

SIG = (20, 24, 16)  # frames 20x24, 16-frame coherence window
KER = (3, 1, 7, 9, 4)


def rel_l2(got, want) -> float:
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


FIDELITIES = {
    "ideal": (r_fid.ideal, t_fid.ideal),
    "physical": (r_fid.physical, t_fid.physical),
    "slm_quantize": (
        lambda: r_fid.pipeline(r_fid.SLMQuantize()),
        lambda: t_fid.pipeline(t_fid.SLMQuantize()),
    ),
}
CASES = [
    ("ideal", "float32", 1e-5),
    ("physical", "float32", 1e-5),
    ("slm_quantize", "float32", 1e-5),
    ("ideal", "bfloat16", 1e-3),
    ("physical", "bfloat16", 1e-3),
]


def engines(name, store="float32", **kw):
    r, t = FIDELITIES[name]
    kw.setdefault("osave_chunk_windows", 2)
    re = RQueryEngine(RConfig(fidelity=r(), use_pallas=True, grating_dtype=store, **kw))
    te = QueryEngine(STHCConfig(fidelity=t(), use_pallas=True, grating_dtype=store, device="cpu", **kw))
    return re, te


def check_peaks(det_t, det_r, scores_rtol):
    """Scores within tolerance; peak indices exact except near-ties in the
    reference's own top two (returns how many positions were excused)."""
    s_t, i_t = det_t.scores.numpy(), det_t.index.numpy()
    s_r, i_r = np.asarray(det_r.scores), np.asarray(det_r.index)
    assert rel_l2(s_t, s_r) < scores_rtol
    near = np.abs(s_r[..., 0] - s_r[..., 1]) <= 1e-5 * np.abs(s_r[..., 0])
    assert np.array_equal(i_t[..., 0][~near], i_r[..., 0][~near])
    return int(near.sum())


@pytest.fixture
def kernels(rng):
    return rng.randn(*KER).astype(np.float32)


@pytest.fixture
def clips(rng):
    return rng.rand(2, 1, 20, 24, 40).astype(np.float32)


@pytest.mark.parametrize("name,store,tol", CASES)
def test_record_and_query_match_reference(name, store, tol, kernels, clips):
    re, te = engines(name, store)
    g_r = re.record(jnp.asarray(kernels), SIG)
    g_t = te.record(kernels, SIG)
    assert g_t.fft_shape == g_r.fft_shape and g_t.out_shape == g_r.out_shape
    assert (g_t.encode, g_t.slm_bits, g_t.pseudo_negative) == (
        g_r.encode, g_r.slm_bits, g_r.pseudo_negative,
    )
    assert g_t.nbytes == g_r.nbytes
    assert rel_l2(g_t.effective_c.numpy(), g_r.effective_c) < (1e-5 if store == "float32" else 1e-3)
    x = clips[..., :16]
    assert rel_l2(te.query(g_t, x).numpy(), re.query(g_r, jnp.asarray(x))) < tol


def test_dense_path_matches_kernel_path(kernels, clips):
    """use_pallas=False (the einsum path) agrees with the kernel path."""
    te = QueryEngine(STHCConfig(fidelity=t_fid.physical(), use_pallas=False, device="cpu"))
    tk = QueryEngine(STHCConfig(fidelity=t_fid.physical(), device="cpu"))
    g = te.record(kernels, SIG)
    x = clips[..., :16]
    assert rel_l2(te.query(g, x).numpy(), tk.query(g, x).numpy()) < 1e-5
    assert rel_l2(
        te.query_stream(g, clips).numpy(), tk.query_stream(g, clips).numpy()
    ) < 1e-5


def test_unfused_reference_path(kernels, clips):
    re, te = engines("physical")
    g_r = re.record(jnp.asarray(kernels), SIG)
    g_t = te.record(kernels, SIG)
    x = clips[..., :16]
    unf = te.query_unfused(g_t, x).numpy()
    assert rel_l2(unf, te.query(g_t, x).numpy()) < 1e-5
    assert rel_l2(unf, re.query_unfused(g_r, jnp.asarray(x))) < 1e-5
    bare = QueryEngine(STHCConfig(fidelity=t_fid.physical(), keep_stacked=False, device="cpu"))
    with pytest.raises(ValueError):
        bare.query_unfused(bare.record(kernels, SIG), x)


@pytest.mark.parametrize("name,store,tol", CASES)
def test_query_stream_matches_reference_chunked_and_unbounded(name, store, tol, kernels, clips):
    re, te = engines(name, store)
    g_r = re.record(jnp.asarray(kernels), SIG)
    g_t = te.record(kernels, SIG)
    vol = te.query_stream(g_t, clips)
    assert rel_l2(vol.numpy(), re.query_stream(g_r, jnp.asarray(clips))) < tol
    det = te.query_stream(g_t, clips, readout_k=3)
    check_peaks(det, re.query_stream(g_r, jnp.asarray(clips), readout_k=3), tol)
    # inside the port: chunked == unbounded, fused == stitched, bitwise
    for mbw in (1, 2):
        assert torch.equal(te.query_stream(g_t, clips, max_buffer_windows=mbw), vol)
        d2 = te.query_stream(g_t, clips, max_buffer_windows=mbw, readout_k=3)
        assert torch.equal(d2.scores, det.scores) and torch.equal(d2.index, det.index)
    flat = vol.reshape(2, 3, -1)
    assert torch.equal(det.peak_scores(), torch.amax(flat, -1))
    assert torch.equal(det.peak_index().long(), torch.argmax(flat, -1))
    t, h, w = det.positions()
    assert torch.equal(t, det.index % vol.shape[-1])


class _Moves:
    """Spies on what a streaming call moves to the engine's device: the
    whole-stream ``_as_input`` and each cursor segment's copy."""

    def __init__(self, monkeypatch):
        self.whole, self.segments = [], []
        as_input = QueryEngine._as_input
        upload = t_engine._SegmentUploader.__call__

        def spy_input(eng, x):
            self.whole.append(_nbytes(x))
            return as_input(eng, x)

        def spy_upload(up, seg):
            self.segments.append(_nbytes(seg))
            return upload(up, seg)

        monkeypatch.setattr(QueryEngine, "_as_input", spy_input)
        monkeypatch.setattr(t_engine._SegmentUploader, "__call__", spy_upload)


def _nbytes(x) -> int:
    return int(np.asarray(x).nbytes) if isinstance(x, np.ndarray) else x.numel() * x.element_size()


@pytest.mark.parametrize("kind", ["numpy", "torch_cpu"])
def test_cursor_moves_one_segment_per_step(kind, kernels, monkeypatch, rng):
    """A host stream through the cursor stays on the host: the engine's
    device receives one segment per step (never the whole stream), and
    the detections equal the unbounded call's bitwise and the
    reference's cursor (numpy, host-side scale) within 1e-5."""
    re, te = engines("physical")
    g_r = re.record(jnp.asarray(kernels), SIG)
    g_t = te.record(kernels, SIG)
    clips = rng.rand(2, 1, 20, 24, 100).astype(np.float32)
    x = clips if kind == "numpy" else torch.from_numpy(clips)
    whole = te.query_stream(g_t, x, readout_k=3)
    mbw = 2
    cursor = t_engine.spectral_conv.StreamCursor(te.stream_plan_for(g_t, clips.shape[-1]), mbw)
    seg_bytes = clips[..., : cursor.peak_buffer_frames].nbytes
    assert len(cursor) > 2 and seg_bytes < clips.nbytes
    moves = _Moves(monkeypatch)
    det = te.query_stream(g_t, x, max_buffer_windows=mbw, readout_k=3)
    assert moves.whole == [] and len(moves.segments) == len(cursor)
    assert max(moves.segments) <= seg_bytes
    assert torch.equal(det.scores, whole.scores) and torch.equal(det.index, whole.index)
    check_peaks(det, re.query_stream(g_r, clips, max_buffer_windows=mbw, readout_k=3), 1e-5)
    # the stitched volume through the cursor too
    vol = te.query_stream(g_t, x, max_buffer_windows=mbw)
    assert max(moves.segments) <= seg_bytes and moves.whole == []
    assert torch.equal(vol, te.query_stream(g_t, clips))


@pytest.mark.parametrize("kind", ["numpy", "torch_cpu"])
def test_pooled_cursor_moves_one_segment_per_step(kind, monkeypatch, rng):
    """The pooled executor's cursor stacks host streams on the host and
    moves one segment of the stack per step; detections equal the
    unbounded pooled call's bitwise."""
    (_, gt0), (_, gt1), _ = _tenants(rng)
    a = rng.rand(1, 1, 20, 24, 80).astype(np.float32)
    b = rng.rand(2, 1, 20, 24, 80).astype(np.float32)
    if kind == "torch_cpu":
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    req = [(gt1, a), (gt1, b), (gt0, a)]
    _, te = engines("ideal")
    whole = te.query_stream_many(req, readout_k=2)
    moves = _Moves(monkeypatch)
    got = te.query_stream_many(req, max_buffer_windows=1, readout_k=2)
    cursor = t_engine.spectral_conv.StreamCursor(te.stream_plan_for(gt1, 80), 1)
    stack_bytes = 3 * 20 * 24 * cursor.peak_buffer_frames * 4
    assert moves.whole == [] and len(moves.segments) == 2 * len(cursor)
    assert max(moves.segments) <= stack_bytes
    for w, g in zip(whole, got):
        assert torch.equal(w.scores, g.scores) and torch.equal(w.index, g.index)


def test_host_stream_and_stack_streams():
    x = np.zeros((1, 1, 2, 3, 4), np.float32)
    h = t_engine.host_stream(x, "cpu")
    assert h.device.type == "cpu" and h.dtype == torch.float32
    assert h.data_ptr() == x.ctypes.data  # float32 numpy is wrapped, not copied
    assert t_engine.host_stream(x.astype(np.float64), "cpu").dtype == torch.float32
    s = t_engine.stack_streams([h, h + 1], "cpu")
    assert s.shape == (2, 1, 2, 3, 4) and torch.equal(s[1], h[0] + 1)


def test_stream_rejects_wrong_frame_size(kernels):
    _, te = engines("ideal")
    g = te.record(kernels, SIG)
    with pytest.raises(ValueError):
        te.query_stream(g, np.zeros((1, 1, 21, 24, 30), np.float32))


def _tenants(rng, te_kw=()):
    """Three tenants, two fidelities with the same encode semantics,
    one ideal: (name, port engine, reference engine) per tenant."""
    out = []
    for name in ("ideal", "physical", "slm_quantize"):
        re, te = engines(name, *(te_kw or ()))
        k = rng.randn(2 + len(out), 1, 7, 9, 4).astype(np.float32)
        out.append((re.record(jnp.asarray(k), SIG), te.record(k, SIG)))
    return out


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_query_stream_many_pooled_dedup_fused(store, rng):
    tol = 1e-5 if store == "float32" else 1e-3
    (gr0, gt0), (gr1, gt1), (gr2, gt2) = _tenants(rng, (store,))
    a = rng.rand(1, 1, 20, 24, 40).astype(np.float32)
    b = rng.rand(2, 1, 20, 24, 40).astype(np.float32)
    t_req = [(gt0, a), (gt1, a), (gt2, a), (gt1, b)]
    r_req = [(gr0, jnp.asarray(a)), (gr1, jnp.asarray(a)), (gr2, jnp.asarray(a)), (gr1, jnp.asarray(b))]
    _, te = engines("ideal", store)
    re, _ = engines("ideal", store)
    vols = te.query_stream_many(t_req)
    # groups: ideal {a}, encoded {a, a, b}; tenants 1 and 2 share clip a
    assert te.pool_stats()["rows_saved"] == 1
    dets = te.query_stream_many(t_req, readout_k=2)
    undeduped = te.query_stream_many(t_req, dedup=False)
    chunked = te.query_stream_many(t_req, max_buffer_windows=1, readout_k=2)
    ref_vols = re.query_stream_many(r_req)
    ref_dets = re.query_stream_many(r_req, readout_k=2)
    for j, (g, x) in enumerate(t_req):
        single = te.query_stream(g, x)
        assert torch.equal(vols[j], single)  # pooled == per-tenant
        assert torch.equal(undeduped[j], vols[j])  # dedup == undeduped
        flat = vols[j].reshape(vols[j].shape[0], vols[j].shape[1], -1)
        assert torch.equal(dets[j].peak_scores(), torch.amax(flat, -1))  # fused == stitched
        assert torch.equal(chunked[j].scores, dets[j].scores)
        assert torch.equal(chunked[j].index, dets[j].index)
        assert rel_l2(vols[j].numpy(), ref_vols[j]) < tol
        check_peaks(dets[j], ref_dets[j], tol)


def _chunk_topk_formula(win, starts, plan, win_out, x_scale, readout, k):
    """The fused readout's chunk reduction as first written: every chunk
    copies its window starts to the device, builds its positions from
    them and masks every output past ``n_valid``."""
    Hp, Wp, step = win_out
    nv = plan.n_valid
    dev = win.device
    if x_scale is not None:
        win = win * x_scale[None]
    t_glob = (
        torch.as_tensor(starts, dtype=torch.long, device=dev)[:, None]
        + torch.arange(step, device=dev)[None, :]
    )
    hw = torch.arange(Hp, device=dev)[:, None] * Wp + torch.arange(Wp, device=dev)[None, :]
    gidx = hw[None, :, :, None] * nv + t_glob[:, None, None, :]
    valid = t_glob < nv
    gidx = torch.where(valid[:, None, None, :], gidx, t_engine.TOPK_EMPTY_IDX).to(torch.int32)
    win = torch.where(
        valid[:, None, None, None, None, :],
        win,
        torch.full((), float("-inf"), dtype=win.dtype, device=dev),
    )
    B, O = win.shape[1], win.shape[2]
    return readout(torch.movedim(win, 0, 2).reshape(B, O, -1), gidx.reshape(-1), k)


@pytest.mark.parametrize(
    "frames,chunk_windows,k,max_buffer_windows",
    [
        (40, 4, 1, None),  # n_valid 37: the one chunk ends mid-chunk, a window all padding
        (55, 4, 3, None),  # n_valid 52: the stream ends exactly on the chunk
        (40, 1, 3, None),  # one window a chunk, the last ends mid-window
        (55, 1, 1, None),  # one window a chunk, exactly on it
        (40, 4, 3, 1),  # the cursor: padded segments, each with its own n_valid
        (55, 1, 1, 1),
    ],
)
def test_chunk_topk_cached_positions_bitwise(
    frames, chunk_windows, k, max_buffer_windows, monkeypatch, rng
):
    """Every window chunk's top-K state from the cached per-geometry
    positions is bitwise the state of the formula that copied each
    chunk's starts to the device; the engine builds one position base
    per geometry and reuses it on every later chunk of that geometry."""
    (_, gt0), (_, gt1), (_, gt2) = _tenants(rng)
    cfg = STHCConfig(
        fidelity=t_fid.ideal(), use_pallas=True, device="cpu", osave_chunk_windows=chunk_windows
    )
    te = QueryEngine(cfg)
    a = rng.rand(1, 1, 20, 24, frames).astype(np.float32)
    b = rng.rand(2, 1, 20, 24, frames).astype(np.float32)
    # groups: ideal {a}, encoded {a, b}, so both de-scale branches run
    req = [(gt0, a), (gt1, b), (gt2, a)]
    chunk_topk = te._chunk_topk
    geoms, calls = set(), []

    def spy(win, t0, plan, index, x_scale, readout, k_):
        got = chunk_topk(win, t0, plan, index, x_scale, readout, k_)
        Hp, Wp, step = win.shape[-3:]
        starts = [t0 + j * step for j in range(plan.chunk)]
        want = _chunk_topk_formula(win, starts, plan, (Hp, Wp, step), x_scale, readout, k_)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        geoms.add((Hp, Wp, step, plan.chunk, plan.n_valid))
        calls.append(t0)
        return got

    monkeypatch.setattr(te, "_chunk_topk", spy)
    run = dict(chunk_windows=chunk_windows, max_buffer_windows=max_buffer_windows, readout_k=k)
    first = te.query_stream_many(req, **run)
    assert calls and te.pool_stats()["readout_index_builds"] == len(geoms)
    before, n_first = te.pool_stats(), len(calls)
    again = te.query_stream_many(req, **run)
    after = te.pool_stats()
    assert after["readout_index_builds"] == before["readout_index_builds"]
    assert after["readout_index_hits"] - before["readout_index_hits"] == len(calls) - n_first
    for d0, d1 in zip(first, again):
        assert torch.equal(d0.scores, d1.scores) and torch.equal(d0.index, d1.index)
    single = te.query_stream(gt1, b, **run)
    assert torch.equal(single.scores, first[1].scores)
    assert torch.equal(single.index, first[1].index)


def test_query_many_matches_reference(rng):
    (gr0, gt0), (gr1, gt1), (gr2, gt2) = _tenants(rng)
    x = rng.rand(2, 1, 20, 24, 16).astype(np.float32)
    y = rng.rand(2, 1, 20, 24, 16).astype(np.float32)
    _, te = engines("ideal")
    re, _ = engines("ideal")
    t_req = [(gt0, x), (gt1, x), (gt2, y)]
    outs = te.query_many(t_req)
    refs = re.query_many([(gr0, jnp.asarray(x)), (gr1, jnp.asarray(x)), (gr2, jnp.asarray(y))])
    for (g, xx), o, r in zip(t_req, outs, refs):
        assert torch.equal(o, te.query(g, xx))
        assert rel_l2(o.numpy(), r) < 1e-5
    with pytest.raises(ValueError):
        te.query_many([(gt0, x[0])])


def _fields(g):
    arr = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return {
        "effective": arr(g.effective), "stacked": arr(g.stacked),
        "eff_re": arr(g.eff_re), "eff_im": arr(g.eff_im),
        "kernel_scale": arr(g.kernel_scale), "echo_gain": arr(g.echo_gain),
        "fft_shape": g.fft_shape, "out_shape": g.out_shape, "ker_shape": g.ker_shape,
        "encode": g.encode, "slm_bits": g.slm_bits,
        "pseudo_negative": g.pseudo_negative, "storage_dtype": g.storage_dtype,
    }


@pytest.mark.parametrize("name,store", [("physical", "float32"), ("slm_quantize", "bfloat16")])
def test_query_parity_on_reference_recorded_grating(name, store, kernels, clips):
    re, te = engines(name, store)
    g_r = re.record(jnp.asarray(kernels), SIG)
    g_t = fused_grating_from_numpy(_fields(g_r), device="cpu")
    if store == "bfloat16":
        assert torch.equal(g_t.eff_re.float(), torch.from_numpy(np.asarray(g_r.eff_re, np.float32)))
    tol = 1e-5
    assert rel_l2(te.query(g_t, clips[..., :16]).numpy(), re.query(g_r, jnp.asarray(clips[..., :16]))) < tol
    assert rel_l2(te.query_stream(g_t, clips).numpy(), re.query_stream(g_r, jnp.asarray(clips))) < tol
    if g_r.stacked is not None:
        assert rel_l2(
            te.query_unfused(g_t, clips[..., :16]).numpy(),
            re.query_unfused(g_r, jnp.asarray(clips[..., :16])),
        ) < tol


def test_sthc_end_to_end_matches_reference(kernels, clips):
    cfg_t = STHCConfig(fidelity=t_fid.physical(), device="cpu", osave_chunk_windows=3)
    cfg_r = RConfig(fidelity=r_fid.physical(), use_pallas=True, osave_chunk_windows=3)
    s_t, s_r = STHC(cfg_t, cache=GratingCache()), RSTHC(cfg_r)
    x = clips[..., :16]
    assert rel_l2(s_t(kernels, x).numpy(), s_r(jnp.asarray(kernels), jnp.asarray(x))) < 1e-5
    assert rel_l2(
        s_t.correlate_stream(kernels, clips, 16).numpy(),
        s_r.correlate_stream(jnp.asarray(kernels), jnp.asarray(clips), 16),
    ) < 1e-5
    s_u = STHC(STHCConfig(fidelity=t_fid.physical(), fused=False, device="cpu"), cache=GratingCache())
    assert rel_l2(s_u(kernels, x).numpy(), s_t(kernels, x).numpy()) < 1e-5


def test_config_device_and_validation():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            STHCConfig()
    assert STHCConfig(device="cpu").device == "cpu"
    assert STHCConfig(device="cpu").use_pallas is True
    with pytest.raises(ValueError):
        STHCConfig(device="cpu", grating_dtype="float16")
    with pytest.raises(ValueError):
        STHCConfig(device="cpu", osave_max_buffer_windows=0)
    with pytest.raises(ValueError):
        STHCConfig(device="cpu", compensate_pulse=False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg = STHCConfig(device="cpu", mode="physical")
    assert cfg.fidelity.fingerprint() == t_fid.physical().fingerprint()
    assert any(issubclass(x.category, DeprecationWarning) for x in w)


def test_grating_cache_lru_verify_and_keys(rng):
    cfg = STHCConfig(fidelity=t_fid.ideal(), device="cpu")
    eng = QueryEngine(cfg)
    ks = [rng.randn(2, 1, 7, 9, 4).astype(np.float32) for _ in range(3)]
    one = eng.record(ks[0], SIG).nbytes
    cache = GratingCache(max_entries=2, max_bytes=2 * one)
    g0 = cache.get_or_record(eng, ks[0], SIG)
    assert cache.get_or_record(eng, ks[0], SIG) is g0
    cache.get_or_record(eng, ks[1], SIG)
    cache.get_or_record(eng, ks[2], SIG)
    st = cache.stats()
    assert (st["hits"], st["misses"], st["evictions"], st["entries"]) == (1, 3, 1, 2)
    assert cache.nbytes == 2 * one
    key = GratingCache.key_for(ks[1], SIG, cfg)
    assert cache.discard(key) and not cache.discard(key)
    phys = STHCConfig(fidelity=t_fid.physical(), device="cpu")
    assert GratingCache.key_for(ks[0], SIG, phys) != GratingCache.key_for(ks[0], SIG, cfg)
    # verify: a corrupted resident grating is re-recorded
    vcache = GratingCache(verify=True)
    g = vcache.get_or_record(eng, ks[0], SIG)
    g.effective[0, 0, 0, 0, 0] = float("nan")
    g2 = vcache.get_or_record(eng, ks[0], SIG)
    assert g2 is not g and vcache.stats()["integrity_failures"] == 1
    assert torch.isfinite(g2.effective.real).all()
    vcache.clear()
    assert len(vcache) == 0


def test_default_cache_is_shared():
    assert t_engine.default_cache() is t_engine.default_cache()
