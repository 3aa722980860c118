"""The port's stmul kernels (B1 spectral MAC, B2 grouped MAC, B3 top-K
readout): every public op against the JAX reference's ops (Pallas in
interpret mode), and the readout's selection semantics — ties, NaN,
sentinel, signed zeros, merge order — against the reference's
``topk_select``.

On the CPU each wrapper runs its plain torch version (``ref.py``), the
same op sequence the CUDA kernel runs; the kernels themselves are held
against these on the card by ``chip_smoke.py``.  Tolerances: relative
L2 <= 1e-5 for float32 spectra and volumes, <= 1e-3 for bf16 arenas;
exact for the readout.
"""

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

from repro.kernels.stmul import kernel as r_kernel  # noqa: E402
from repro.kernels.stmul import ops as r_ops  # noqa: E402
from repro.kernels.stmul import ref as r_ref  # noqa: E402
from repro_torch.kernels.stmul import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.stmul import ops as t_ops  # noqa: E402
from repro_torch.kernels.stmul import ref as t_ref  # noqa: E402

RTOL = 1e-5
EMPTY = t_ref.TOPK_EMPTY_IDX


def rel_l2(got, want) -> float:
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def cplx(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- MAC kernels vs the reference ops -----------------------------------------


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("C", [1, 3])
def test_spectral_mac_matches_reference(version, C, rng):
    x = cplx(rng, 3, C, 5, 6, 4)
    g = cplx(rng, 2, C, 5, 6, 4)
    got = t_ops.spectral_mac(T(x), T(g), version=version)
    want = r_ops.spectral_mac(jnp.asarray(x), jnp.asarray(g), version=version)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert rel_l2(got.numpy(), want) < RTOL
    assert rel_l2(got.numpy(), r_ref.spectral_mac_ref(jnp.asarray(x), jnp.asarray(g))) < RTOL


def test_spectral_mac_versions_and_unknown_version(rng):
    x, g = T(cplx(rng, 2, 1, 40)), T(cplx(rng, 3, 1, 40))
    v1 = t_ref.spectral_mac_ref(x, g, 1)
    v2 = t_ref.spectral_mac_ref(x, g, 2)
    assert rel_l2(v1.numpy(), v2.numpy()) < RTOL
    with pytest.raises(ValueError):
        t_ref.spectral_mac_ref(x, g, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spectral_mac_grouped_matches_reference(dtype, rng):
    x = cplx(rng, 4, 2, 3, 5, 4)
    arena = cplx(rng, 11, 2, 3, 5, 4)
    o_start = [0, 5, 2, 5]
    re = torch.from_numpy(arena.real.copy())
    im = torch.from_numpy(arena.imag.copy())
    re_j, im_j = jnp.asarray(arena.real), jnp.asarray(arena.imag)
    if dtype == "bfloat16":
        re, im = re.to(torch.bfloat16), im.to(torch.bfloat16)
        re_j, im_j = re_j.astype(jnp.bfloat16), im_j.astype(jnp.bfloat16)
    got = t_ops.spectral_mac_grouped(T(x), re, im, o_start, 6)
    # the reference kernel needs block_o-aligned offsets; its loop oracle
    # takes any rows
    arena_j = re_j.astype(jnp.float32) + 1j * im_j.astype(jnp.float32)
    want = r_ref.spectral_mac_grouped_ref(jnp.asarray(x), arena_j, o_start, 6)
    assert got.shape == want.shape
    assert rel_l2(got.numpy(), want) < RTOL
    aligned = r_ops.spectral_mac_grouped(
        jnp.asarray(x), re_j, im_j, jnp.asarray([0, 8, 0, 8]), 3, block_o=8
    )
    got_al = t_ops.spectral_mac_grouped(T(x), re, im, [0, 8, 0, 8], 3)
    assert rel_l2(got_al.numpy(), aligned) < RTOL


def test_grouped_equals_single_grating_bitwise(rng):
    """A pooled row reading one tenant's slice is bitwise the single-grating
    MAC against that tenant (same op sequence in both plain versions, as
    in both CUDA kernels)."""
    x = T(cplx(rng, 2, 1, 64))
    arena = T(cplx(rng, 7, 1, 64))
    pooled = t_ops.spectral_mac_grouped(x, arena.real.contiguous(), arena.imag.contiguous(), [4, 4], 3)
    single = t_ops.spectral_mac(x, arena[4:7].contiguous())
    assert torch.equal(pooled, single)


def test_query_grating_ops_match_reference(rng):
    x = rng.rand(2, 1, 8, 9, 10).astype(np.float32)
    g = cplx(rng, 3, 1, 12, 15, 7)
    fs, out = (12, 15, 12), (4, 5, 6)
    got = t_ops.query_grating_pallas(T(x), T(g), fs, out)
    want = r_ops.query_grating_pallas(jnp.asarray(x), jnp.asarray(g), fs, out)
    assert rel_l2(got.numpy(), want) < RTOL
    pad = np.zeros((5,) + g.shape[1:], np.float32)
    pre = np.concatenate([g.real, pad])
    pim = np.concatenate([g.imag, pad])
    got = t_ops.query_grating_pooled(T(x), T(pre), T(pim), [0, 0], 8, fs, out)
    want = r_ops.query_grating_pooled(
        jnp.asarray(x), jnp.asarray(pre), jnp.asarray(pim), jnp.asarray([0, 0]), 8, fs, out
    )
    assert rel_l2(got.numpy(), want) < RTOL


def test_cuda_wrappers_refuse_host_tensors(rng):
    """A wrapper given CPU tensors never launches (and never builds): the
    routing in ops.py picks the plain version by device instead."""
    x = T(cplx(rng, 1, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.spectral_mac_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.spectral_mac_grouped_cuda(x, x.real, x.imag, [0], 1)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.topk_readout_cuda(torch.zeros(1, 4), torch.arange(4, dtype=torch.int32), 1)
    t_kernel.reset_launches()
    t_ops.spectral_mac(x, x)
    t_ops.topk_readout(torch.zeros(1, 1, 4), torch.arange(4, dtype=torch.int32), 1)
    assert t_kernel.spectral_mac_cuda.launches == 0
    assert t_kernel.topk_readout_cuda.launches == 0


# -- readout semantics (mirrors tests/test_readout.py) --------------------------


def _scores(rng, B=2, O=3, L=700, ties=True):
    v = rng.randn(B, O, L).astype(np.float32)
    if ties:
        v[..., 1::7] = v[..., 0::7][..., : v[..., 1::7].shape[-1]]
    return v


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_topk_readout_matches_reference(k, use_pallas, rng):
    vals = _scores(rng)
    gidx = np.arange(vals.shape[-1], dtype=np.int32)
    s, ix = t_ops.topk_readout(T(vals), T(gidx), k, use_pallas=use_pallas)
    s_r, i_r = r_ref.topk_readout_ref(jnp.asarray(vals), jnp.asarray(gidx), k)
    assert np.array_equal(s.numpy(), np.asarray(s_r))
    assert np.array_equal(ix.numpy(), np.asarray(i_r))
    s_p, i_p = r_ops.topk_readout(jnp.asarray(vals), jnp.asarray(gidx), k, use_pallas=True)
    assert np.array_equal(ix.numpy(), np.asarray(i_p))


def test_topk_k1_is_first_occurrence_argmax(rng):
    vals = _scores(rng, L=301)
    s, ix = t_ops.topk_readout(T(vals), torch.arange(301, dtype=torch.int32), 1)
    assert np.array_equal(s[..., 0].numpy(), vals.max(-1))
    assert np.array_equal(ix[..., 0].numpy(), vals.argmax(-1))


@pytest.mark.parametrize("split", [[5, 9, 1], [1, 1, 1, 1, 11], [15]])
def test_topk_merge_rechunk_and_permutation_invariant(split, rng):
    vals = _scores(rng, L=300)
    gidx = rng.permutation(300).astype(np.int32)
    whole = t_ref.topk_select(T(vals), T(np.broadcast_to(gidx, vals.shape)), 4)
    bounds = np.cumsum([0] + split) * 20
    states = [
        t_ops.topk_readout(T(vals[..., a:b]), T(gidx[a:b]), 4)
        for a, b in zip(bounds[:-1], bounds[1:])
    ]
    for order in (states, states[::-1], states[1:] + states[:1]):
        s, i = t_ops.merge_topk(order, 4)
        assert torch.equal(s, whole[0]) and torch.equal(i, whole[1])


def test_topk_k_geq_candidates_pads_with_sentinel():
    vals = torch.tensor([[[3.0, float("-inf"), 1.0]]])
    gidx = torch.tensor([7, 8, 9], dtype=torch.int32)
    s, i = t_ops.topk_readout(vals, gidx, 5)
    assert s[0, 0].tolist()[:2] == [3.0, 1.0]
    assert all(v == float("-inf") for v in s[0, 0].tolist()[2:])
    assert i[0, 0].tolist() == [7, 9, EMPTY, EMPTY, EMPTY]
    s_r, i_r = r_kernel.topk_select(
        jnp.asarray(vals.numpy()), jnp.asarray(np.broadcast_to(gidx.numpy(), (1, 1, 3))), 5
    )
    assert np.array_equal(i.numpy(), np.asarray(i_r))
    assert np.array_equal(s.numpy(), np.asarray(s_r))


def test_topk_nan_poisons_row_and_only_that_row(rng):
    vals = _scores(rng, B=2, O=2, L=50)
    vals[1, 0, 17] = np.nan
    gidx = np.arange(50, dtype=np.int32)
    s, i = t_ops.topk_readout(T(vals), T(gidx), 3)
    assert torch.isnan(s[1, 0]).all() and (i[1, 0] == EMPTY).all()
    clean = np.ones((2, 2), bool)
    clean[1, 0] = False
    s_r, i_r = r_ref.topk_readout_ref(jnp.asarray(vals), jnp.asarray(gidx), 3)
    assert np.array_equal(s.numpy()[clean], np.asarray(s_r)[clean])
    assert np.array_equal(i.numpy(), np.asarray(r_kernel.topk_select(
        jnp.asarray(vals), jnp.asarray(np.broadcast_to(gidx, vals.shape)), 3)[1]))
    # poisoned states stay poisoned through any merge
    s2, i2 = t_ops.merge_topk([(s, i), (s, i)], 3)
    assert torch.isnan(s2[1, 0]).all() and (i2[1, 0] == EMPTY).all()
    # the kernel's canonical quiet NaN
    assert s[1, 0].view(torch.int32).eq(0x7FC00000).all()


def test_topk_signed_zero_ties_resolve_by_index():
    """+0 and −0 tie; the smaller index wins and the slot reports that
    element's own value (the CUDA kernel does the same)."""
    vals = torch.tensor([[0.0, -0.0, -1.0, -0.0, 0.0]])
    gidx = torch.tensor([4, 1, 0, 3, 2], dtype=torch.int32)
    s, i = t_ops.topk_readout(vals, gidx, 4)
    assert i[0].tolist() == [1, 2, 3, 4]
    assert [np.signbit(v) for v in s[0].tolist()] == [True, False, True, False]
    s_r, i_r = r_kernel.topk_select(
        jnp.asarray(vals.numpy()), jnp.asarray(gidx.numpy()[None]), 4
    )
    assert np.array_equal(i.numpy(), np.asarray(i_r))
    assert np.array_equal(s.numpy(), np.asarray(s_r))  # values equal



# -- B3's split of the score axis (kernel.topk_plan) ----------------------------


@pytest.mark.parametrize("R", [1, 9, 18, 36])
@pytest.mark.parametrize("L", [1, 3, 700, 289_788])
def test_topk_plan_covers_the_row_and_fills_the_card(R, L):
    """S slices of n scores tile [0, L) exactly (no empty slice), start on
    16-byte boundaries when L % 4 == 0, and R·S reaches the fill target
    unless the slices are already at their minimum length."""
    S, n = t_kernel.topk_plan(R, L)
    bounds = [(s * n, min((s + 1) * n, L)) for s in range(S)]
    assert bounds[0][0] == 0 and bounds[-1][1] == L
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    assert n % 4 == 0
    if L % 4 == 0:
        assert all((R_ * L + a) * 4 % 16 == 0 for R_ in range(R) for a, _ in bounds)
    min_n = t_kernel.TOPK_THREADS * t_kernel.TOPK_MIN_PER_THREAD
    assert R * S >= t_kernel.TOPK_FILL_BLOCKS or n == min_n
    assert n >= min_n  # every thread reads at least TOPK_MIN_PER_THREAD scores


def test_topk_plan_at_the_serving_shapes():
    assert t_kernel.topk_plan(36, 289_788) == (15, 19_320)
    assert t_kernel.topk_plan(18, 289_788) == (30, 9_660)
    assert t_kernel.topk_plan(9, 289_788) == (59, 4_912)
    with pytest.raises(ValueError):
        t_kernel.topk_plan(0, 10)


def _straddling(rng, R, L, plan):
    """Ties, NaN, -inf stretches and ±0 runs placed on the plan's slice
    boundaries (rows take the boundaries in turn)."""
    S, n = plan
    v = rng.randn(R, L).astype(np.float32)
    cuts = [s * n for s in range(1, S)] or [L // 2]
    for r in range(R):
        c = cuts[r % len(cuts)]
        kind = r % 6
        if kind == 0:
            v[r, c - 3 : c + 3] = 10.0
        elif kind == 1:
            v[r, c] = np.nan
        elif kind == 2:
            v[r, c - 1] = np.nan
        elif kind == 3:
            v[r] = -np.inf
            v[r, c - 1] = v[r, c + 1] = 1.0
        elif kind == 4:
            v[r] = -1.0 - np.abs(v[r])
            v[r, c - 2 : c + 2] = [0.0, -0.0, 0.0, -0.0]
        else:
            lo, hi = max(c - 500, 1), min(c + 500, L - 1)
            v[r, lo:hi] = -np.inf
            v[r, lo - 1] = v[r, hi] = 9.0
    return v


@pytest.mark.parametrize(
    "R,L,k", [(6, 20_000, 1), (6, 20_000, 3), (6, 20_000, 4), (6, 20_000, 32), (9, 289_788, 1), (9, 289_788, 3)]
)
def test_topk_slice_merge_is_the_one_shot_readout_bitwise(R, L, k, rng):
    """What the two-pass kernel computes: per-slice readouts over the
    plan's own slices, merged, equal the one-shot readout bit for bit —
    with the ties, NaN, -inf and ±0 straddling the slice boundaries."""
    plan = t_kernel.topk_plan(R, L)
    assert plan[0] > 1
    v = T(_straddling(rng, R, L, plan))
    gidx = T(rng.permutation(L).astype(np.int32))
    whole = t_ref.topk_readout_ref(v, gidx, k)
    S, n = plan
    states = [t_ref.topk_readout_ref(v[:, s * n : (s + 1) * n], gidx[s * n : (s + 1) * n], k)
              for s in range(S)]
    for order in (states, states[::-1]):
        s_m, i_m = t_ops.merge_topk(order, k)
        assert torch.equal(s_m.view(torch.int32), whole[0].view(torch.int32))
        assert torch.equal(i_m, whole[1])
    nan_rows = torch.isnan(v).any(dim=1)
    assert nan_rows.any() and torch.isnan(whole[0][nan_rows]).all()
    assert (whole[1][nan_rows] == EMPTY).all()


def test_kernel_constants_mirror_the_cuda_source():
    """The wrapper's plan and limits are the ones the CUDA source builds
    with (its pass-1 block size, its list bound, its row limit)."""
    import re
    from pathlib import Path

    src = (Path(t_kernel.__file__).parent / "csrc" / "stmul.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kTopkThreads") == t_kernel.TOPK_THREADS
    assert const("kTopkMaxK") == t_kernel.TOPK_MAX_K
    assert const("kMacGroupedMaxRows") == t_kernel.MAC_GROUPED_MAX_ROWS
    assert const("kMacThreads") == t_kernel.MAC_THREADS
    assert const("kMacRegRows") == t_kernel.MAC_REG_ROWS


# -- B1's launch plan (kernel.mac_plan) ------------------------------------------


def _blocks_of_plan(blocks, B, F, paired):
    """Every block's (bins, batch row) as the kernel assigns them: tile
    blk // B, row blk % B; thread t owns bins 2t and 2t + 1 of the tile
    when paired, else t and t + threads, the second only inside [0, F)."""
    threads = t_kernel.MAC_THREADS
    t = np.arange(threads)
    for blk in range(blocks):
        tile, b = divmod(blk, B)
        f0 = 2 * tile * threads + (2 * t if paired else t)
        step = 1 if paired else threads
        live = f0 < F
        yield np.concatenate([f0[live], (f0 + step)[live & (f0 + step < F)]]), b


@pytest.mark.parametrize(
    "B,O,C,F",
    [(8, 9, 1, 399_600), (16, 9, 1, 140_400), (3, 20, 1, 1001), (1, 1, 1, 7), (4, 9, 3, 10_000),
     (4, 9, 3, 10_001), (5, 40, 12, 513), (2, 9, 13, 64), (2, 9, 48, 64), (3, 5, 49, 64), (1, 3, 200, 33)],
)
def test_mac_plan_covers_every_bin_and_row(B, O, C, F):
    """B1's plan tiles the (batch row, bin) plane (paired and scalar
    ownership alike) and the grating rows exactly once, registers only
    at C = 1; chunking the O axis as planned leaves the plain version's
    result bitwise unchanged."""
    blocks, rows, where = t_kernel.mac_plan(B, O, C, F)
    assert blocks == -(-F // (2 * t_kernel.MAC_THREADS)) * B and 1 <= rows <= O
    if where == "registers":
        assert C == 1 and rows == min(O, t_kernel.MAC_REG_ROWS)
    else:
        assert where == "global" and C > 1 and rows == O
    chunks = [list(range(o0, min(o0 + rows, O))) for o0 in range(0, O, rows)]
    assert sum(chunks, []) == list(range(O))
    for paired in ((True, False) if F % 2 == 0 else (False,)):
        seen = np.zeros((B, F), np.int64)
        for bins, b in _blocks_of_plan(blocks, B, F, paired):
            seen[b, bins] += 1
        assert (seen == 1).all()
    if F <= 10_001:
        rng = np.random.RandomState(O + C + F)
        x, g = T(cplx(rng, B, C, F)), T(cplx(rng, O, C, F))
        for version in (1, 2):
            whole = t_ref.spectral_mac_ref(x, g, version)
            parts = torch.cat([t_ref.spectral_mac_ref(x, g[ch[0]:ch[-1] + 1], version) for ch in chunks], 1)
            assert torch.equal(whole, parts)


def test_mac_plan_at_the_serving_shapes():
    # both main shapes: the grating in one chunk, one block per (tile, row)
    assert t_kernel.mac_plan(8, 9, 1, 399_600) == (1561 * 8, 9, "registers")
    assert t_kernel.mac_plan(16, 9, 1, 140_400) == (549 * 16, 9, "registers")
    assert t_kernel.mac_plan(1, 20, 1, 256) == (1, 9, "registers")
    assert t_kernel.mac_plan(4, 9, 3, 257) == (8, 9, "global")
    with pytest.raises(ValueError):
        t_kernel.mac_plan(1, 0, 1, 256)
