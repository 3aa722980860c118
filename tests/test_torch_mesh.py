"""The port's mesh-sharded video search (``QueryEngine.query_stream_many``
/ ``query_many`` with ``mesh=``, ``launch/mesh.py``, the server's
``mesh_shape``): twins of ``tests/test_mesh.py`` on the CPU.

A port mesh is a ``(data, model)`` grid of torch devices in one process,
and a device may repeat, so ``make_local_mesh(2, 4, devices=("cpu",) *
8)`` stands in for the reference's eight forced host devices and every
case runs un-skipped.  Inside the port the mesh path is held bitwise
against the single-device path; the stream volumes run with four
intra-op threads, where a lone CPU FFT of this geometry rounds
differently from a batched one (ROADMAP C.14), so the (8, 1) mesh — one
stream row per data shard — is checked where that trap bites.

Against the reference: packing and binning equal the reference's; the
port's (2, 4) results against the reference's single-device results in
this process, and against the reference's own (2, 4) mesh run in a
subprocess with eight forced host devices — relative L2 <= 1e-5 for
float32, <= 1e-3 with bf16 gratings, peak indices exact except where the
reference's own two best scores lie within 1e-5 relative.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from _hypo import given, settings, st

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as r_engine  # noqa: E402
from repro.core import fidelity as r_fid  # noqa: E402
from repro.core.sthc import STHC as RSTHC  # noqa: E402
from repro.core.sthc import STHCConfig as RConfig  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core import fidelity as fid  # noqa: E402
from repro_torch.core.sthc import STHC, STHCConfig  # noqa: E402
from repro_torch.launch.mesh import LocalMesh, make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.serve import VideoSearchConfig, VideoSearchServer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TENANT_O = (3, 5, 2, 4)
TENANT_B = (2, 1, 3, 2)


def cpu_mesh(data, model) -> LocalMesh:
    return make_local_mesh(data, model, devices=("cpu",) * (data * model))


def _kernels(seed, O=3, C=1, kh=7, kw=9, kt=4):
    rng = np.random.RandomState(seed)
    return rng.randn(O, C, kh, kw, kt).astype(np.float32)


def _clips(seed, B=2, C=1, H=20, W=24, T=40):
    rng = np.random.RandomState(100 + seed)
    return rng.rand(B, C, H, W, T).astype(np.float32)


def _bitwise(a, b):
    a = [(d.scores, d.index) if isinstance(d, engine_mod.TopKDetections) else (d,) for d in a]
    b = [(d.scores, d.index) if isinstance(d, engine_mod.TopKDetections) else (d,) for d in b]
    assert len(a) == len(b)
    return all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))


def _requests(eng, T=40):
    ks = [_kernels(i, O=o) for i, o in enumerate(TENANT_O)]
    xs = [_clips(i, B=b, T=T) for i, b in enumerate(TENANT_B)]
    gs = [eng.record(k, x.shape[-3:]) for k, x in zip(ks, xs)]
    return list(zip(gs, xs))


def _engine(**over):
    cfg = dict(fidelity=fid.physical(), osave_chunk_windows=2, device="cpu")
    cfg.update(over)
    return STHC(STHCConfig(**cfg)).engine


def _r_engine(**over):
    cfg = dict(fidelity=r_fid.physical(), osave_chunk_windows=2)
    cfg.update(over)
    return RSTHC(RConfig(**cfg)).engine


# ---------------------------------------------------------------------------
# bitwise equality: sharded == single-device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (1, 8), (2, 4)])
def test_stream_volumes_bitwise(shape):
    threads = torch.get_num_threads()
    torch.set_num_threads(4)  # where a lone FFT of this geometry rounds apart
    try:
        eng = _engine()
        reqs = _requests(eng)
        ref = eng.query_stream_many(reqs, dedup=True)
        got = eng.query_stream_many(reqs, dedup=True, mesh=cpu_mesh(*shape))
    finally:
        torch.set_num_threads(threads)
    assert _bitwise(ref, got)


def test_stream_fused_topk_bitwise():
    eng = _engine()
    reqs = _requests(eng)
    mesh = cpu_mesh(2, 4)
    ref = eng.query_stream_many(reqs, dedup=True, readout_k=3)
    got = eng.query_stream_many(reqs, dedup=True, readout_k=3, mesh=mesh)
    assert _bitwise(ref, got)


def test_shared_stream_dedup_bitwise():
    """All tenants searching one content-equal clip: dedup collapses to
    unique physical rows on the mesh too, and scores stay bitwise."""
    eng = _engine()
    gs = [g for g, _ in _requests(eng)]
    shared = _clips(9)
    reqs = [(g, shared) for g in gs]
    mesh = cpu_mesh(2, 4)
    ref = eng.query_stream_many(reqs, dedup=True, readout_k=2)
    before = eng.pool_stats()
    got = eng.query_stream_many(reqs, dedup=True, readout_k=2, mesh=mesh)
    after = eng.pool_stats()
    assert after["rows_dispatched"] - before["rows_dispatched"] == shared.shape[0]
    assert _bitwise(ref, got)


@pytest.mark.parametrize("readout_k", [None, 2])
def test_chunked_cursor_bitwise(readout_k):
    """Bounded-memory StreamCursor segments ride the sharded driver."""
    eng = _engine()
    reqs = _requests(eng)
    mesh = cpu_mesh(2, 4)
    kw = dict(dedup=True, max_buffer_windows=3, readout_k=readout_k)
    ref = eng.query_stream_many(reqs, **kw)
    got = eng.query_stream_many(reqs, mesh=mesh, **kw)
    assert _bitwise(ref, got)


def test_bf16_storage_bitwise():
    eng = _engine(grating_dtype="bfloat16")
    reqs = _requests(eng)
    mesh = cpu_mesh(2, 4)
    ref = eng.query_stream_many(reqs, dedup=True, readout_k=2)
    got = eng.query_stream_many(reqs, dedup=True, readout_k=2, mesh=mesh)
    assert _bitwise(ref, got)


def test_pallas_grouped_kernel_bitwise():
    """The grouped route (B2's plain version on CPU tensors): every shard
    through ``pooled_query_shard``."""
    eng = _engine(use_pallas=True)
    reqs = _requests(eng)
    mesh = cpu_mesh(2, 4)
    ref = eng.query_stream_many(reqs, dedup=True)
    got = eng.query_stream_many(reqs, dedup=True, mesh=mesh)
    assert _bitwise(ref, got)


def test_query_many_oneshot_bitwise():
    eng = _engine()
    ks = [_kernels(i, O=o) for i, o in enumerate(TENANT_O)]
    xs = [_clips(i, B=b, T=10) for i, b in enumerate(TENANT_B)]
    gs = [eng.record(k, x.shape[-3:]) for k, x in zip(ks, xs)]
    reqs = list(zip(gs, xs))
    ref = eng.query_many(reqs, dedup=True)
    got = eng.query_many(reqs, dedup=True, mesh=cpu_mesh(2, 4))
    assert _bitwise(ref, got)


def test_serving_end_to_end_mesh():
    """A mesh-configured server serves bitwise-identical detections."""
    k = _kernels(0, O=2, kh=3, kw=4, kt=3)
    clip = _clips(0, B=1, H=12, W=12, T=20)
    ref_srv = VideoSearchServer(k, (12, 12), cfg=VideoSearchConfig(window_frames=8, device="cpu"))
    mesh_srv = VideoSearchServer(
        k, (12, 12),
        cfg=VideoSearchConfig(
            window_frames=8, mesh_shape=(2, 4), mesh_devices=("cpu",) * 8, device="cpu"
        ),
    )
    assert mesh_srv.mesh is not None and mesh_srv.mesh.size == 8
    ref_out = ref_srv.search(clip)
    got_out = mesh_srv.search(clip)
    assert np.array_equal(ref_out["scores"].view(np.int32), got_out["scores"].view(np.int32))
    assert np.array_equal(ref_out["peak_frame"], got_out["peak_frame"])
    assert mesh_srv.metrics()["mesh"] == {"shape": {"data": 2, "model": 4}, "devices": 8}
    assert ref_srv.metrics()["mesh"] is None


# ---------------------------------------------------------------------------
# shard-tiled arena packing, against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_pool_packing_matches_reference(shards):
    """The port's slots are back to back (the reference's align = 1): its
    packing equals the reference's ``_build_pool(members, 1, shards)``
    row for row, every slot inside one tile, tiles equal-height."""
    eng = _engine()
    r_eng = _r_engine()
    widths = (3, 5, 2, 4, 1, 7)
    ks = [_kernels(i, O=o) for i, o in enumerate(widths)]
    gs = [eng.record(k, (20, 24, 10)) for k in ks]
    pool = engine_mod._build_pool(gs, shards)
    r_pool = r_engine._build_pool([r_eng.record(jnp.asarray(k), (20, 24, 10)) for k in ks], 1, shards)
    assert pool.shards == r_pool.shards == shards
    assert pool.o_start == r_pool.o_start
    assert pool.shard_rows == r_pool.shard_rows
    assert tuple(pool.re.shape) == tuple(r_pool.re.shape)
    assert int(pool.re.shape[0]) == shards * pool.shard_rows
    for o0, g in zip(pool.o_start, gs):
        if shards > 1:
            assert o0 // pool.shard_rows == (o0 + g.n_out - 1) // pool.shard_rows
        re, im = g.planes
        assert torch.equal(pool.re[o0 : o0 + g.n_out], re)
        assert torch.equal(pool.im[o0 : o0 + g.n_out], im)
    # every row outside a member slot is zero, as in the reference's tiles
    live = torch.zeros(pool.re.shape[0], dtype=torch.bool)
    for o0, g in zip(pool.o_start, gs):
        live[o0 : o0 + g.n_out] = True
    assert not pool.re[~live].any() and not pool.im[~live].any()
    assert not np.asarray(r_pool.re)[~live.numpy()].any()


def test_bin_members_deterministic_least_loaded():
    bin_of, shard_rows = engine_mod._bin_members([5, 3, 4, 2], 2)
    # greedy least-loaded: 5->t0, 3->t1, 4->t1 (load 3<5), 2->t0
    assert bin_of == [0, 1, 1, 0]
    assert shard_rows == 7
    # ties break to the lowest tile index — deterministic
    bin_of, _ = engine_mod._bin_members([1, 1, 1, 1], 4)
    assert bin_of == [0, 1, 2, 3]


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10**6), n=st.integers(1, 12), shards=st.integers(1, 8))
def test_bin_members_matches_reference(seed, n, shards):
    slots = [int(s) for s in np.random.RandomState(seed).randint(1, 10, size=n)]
    assert engine_mod._bin_members(slots, shards) == r_engine._bin_members(slots, shards)


# ---------------------------------------------------------------------------
# construction-time validation
# ---------------------------------------------------------------------------


def test_make_local_mesh_raises_on_short_device_count():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("environment unexpectedly has >= 64 devices")
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        make_local_mesh(8, 8)
    with pytest.raises(ValueError, match="exactly 8 devices"):
        make_local_mesh(2, 4, devices=("cpu",) * 7)
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True)


def test_local_mesh_grid_is_row_major():
    mesh = make_local_mesh(2, 3, devices=[f"cpu:{i}" for i in range(6)])
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert [[d.index for d in row] for row in mesh.devices] == [[0, 1, 2], [3, 4, 5]]
    assert mesh.device(1, 0) == torch.device("cpu", 3)
    assert mesh == make_local_mesh(2, 3, devices=[f"cpu:{i}" for i in range(6)])


def test_make_local_mesh_rejects_bad_axes():
    with pytest.raises(ValueError, match="mesh axes"):
        make_local_mesh(0, 2)
    with pytest.raises(ValueError, match="mesh axes"):
        make_local_mesh(2, 0, devices=())


@pytest.mark.parametrize(
    "bad", [(0, 1), (2,), (2, 2, 2), ("2", "4"), (True, 2), 8]
)
def test_config_rejects_bad_mesh_shape(bad):
    with pytest.raises((ValueError, TypeError)):
        VideoSearchConfig(mesh_shape=bad, device="cpu")


def test_config_accepts_mesh_shape_list():
    cfg = VideoSearchConfig(mesh_shape=[2, 4], mesh_devices=["cpu"] * 8, device="cpu")
    assert cfg.mesh_shape == (2, 4) and cfg.mesh_devices == ("cpu",) * 8
    assert VideoSearchConfig(device="cpu").mesh_shape is None
    with pytest.raises(ValueError, match="mesh_shape"):
        VideoSearchConfig(mesh_devices=("cpu",), device="cpu")


@pytest.mark.parametrize(
    "device,mesh_shape,mesh_devices",
    [("cpu", (1, 1), None), (None, (1, 2), ("cpu",) * 2), ("cpu", (1, 2), ("cpu", "cuda:0"))],
)
def test_config_rejects_mesh_devices_of_another_type(device, mesh_shape, mesh_devices):
    # a CPU server on the card's default mesh, a card server on a CPU
    # mesh, and a mesh mixing the two: each raises before any device is
    # touched
    with pytest.raises(ValueError, match="mesh devices"):
        VideoSearchConfig(device=device, mesh_shape=mesh_shape, mesh_devices=mesh_devices)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _check_detections(got, want_s, want_i, rtol):
    """Scores within ``rtol``; peak indices exact outside the
    reference's near-ties in its own top two."""
    s_t, i_t = got.scores.numpy(), got.index.numpy()
    s_r, i_r = np.asarray(want_s), np.asarray(want_i)
    assert rel_l2(s_t, s_r) < rtol
    near = np.abs(s_r[..., 0] - s_r[..., 1]) <= 1e-5 * np.abs(s_r[..., 0])
    assert np.array_equal(i_t[..., 0][~near], i_r[..., 0][~near])


def _port_mesh_results(store):
    eng = _engine(grating_dtype=store)
    reqs = _requests(eng)
    mesh = cpu_mesh(2, 4)
    vols = eng.query_stream_many(reqs, dedup=True, mesh=mesh)
    dets = eng.query_stream_many(reqs, dedup=True, readout_k=3, mesh=mesh)
    return vols, dets


@pytest.mark.parametrize("store,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_mesh_matches_reference_single_device(store, tol):
    """The port's (2, 4) mesh against the reference's single-device
    pooled executor on the same numpy inputs."""
    r_eng = _r_engine(grating_dtype=store)
    r_reqs = [(g, jnp.asarray(x)) for g, x in _requests(r_eng)]
    r_vols = r_eng.query_stream_many(r_reqs, dedup=True)
    r_dets = r_eng.query_stream_many(r_reqs, dedup=True, readout_k=3)
    vols, dets = _port_mesh_results(store)
    for v, rv in zip(vols, r_vols):
        assert tuple(v.shape) == tuple(rv.shape)
        assert rel_l2(v.numpy(), rv) < tol
    for d, rd in zip(dets, r_dets):
        _check_detections(d, rd.scores, rd.index, tol)


REFERENCE_MESH_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
import jax.numpy as jnp
# the reference was written for meshes of automatic axes (jax.make_mesh's
# default up to the jax that CI pins); where the default is explicit axes,
# its slicing of a sharded output raises, so its mesh is built as written for
if hasattr(jax.sharding, "AxisType"):
    _make_mesh = jax.make_mesh
    jax.make_mesh = lambda shape, axes, **kw: _make_mesh(
        shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes), **kw)
from repro.core import fidelity as fid
from repro.core.sthc import STHC, STHCConfig
from repro.launch.mesh import make_local_mesh

out = {}
mesh = make_local_mesh(2, 4)
for store in ("float32", "bfloat16"):
    eng = STHC(STHCConfig(fidelity=fid.physical(), osave_chunk_windows=2,
                          grating_dtype=store)).engine
    reqs = []
    for i, (o, b) in enumerate(zip((3, 5, 2, 4), (2, 1, 3, 2))):
        k = np.random.RandomState(i).randn(o, 1, 7, 9, 4).astype(np.float32)
        x = np.random.RandomState(100 + i).rand(b, 1, 20, 24, 40).astype(np.float32)
        reqs.append((eng.record(jnp.asarray(k), x.shape[-3:]), jnp.asarray(x)))
    vols = eng.query_stream_many(reqs, dedup=True, mesh=mesh)
    dets = eng.query_stream_many(reqs, dedup=True, readout_k=3, mesh=mesh)
    for j, (v, d) in enumerate(zip(vols, dets)):
        out[f"{store}_vol{j}"] = np.asarray(v)
        out[f"{store}_s{j}"] = np.asarray(d.scores)
        out[f"{store}_i{j}"] = np.asarray(d.index)
np.savez(sys.argv[1], **out)
print("REFERENCE_MESH_OK", jax.device_count())
"""


def test_mesh_matches_reference_mesh_subprocess(tmp_path):
    """The reference's own (2, 4) mesh on eight forced host devices (a
    subprocess, so this process keeps one), against the port's (2, 4)."""
    path = str(tmp_path / "ref_mesh.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_MESH_SCRIPT, path],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert "REFERENCE_MESH_OK 8" in proc.stdout, proc.stderr[-2000:]
    ref = np.load(path)
    for store, tol in (("float32", 1e-5), ("bfloat16", 1e-3)):
        vols, dets = _port_mesh_results(store)
        for j, (v, d) in enumerate(zip(vols, dets)):
            assert tuple(v.shape) == ref[f"{store}_vol{j}"].shape
            assert rel_l2(v.numpy(), ref[f"{store}_vol{j}"]) < tol
            _check_detections(d, ref[f"{store}_s{j}"], ref[f"{store}_i{j}"], tol)
