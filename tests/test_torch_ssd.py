"""The port's SSD operator (kernel B5's plain version, the exact scan, the
public ``ssd`` / ``ssd_decode_step`` ops) against the JAX reference's:
the same numpy inputs, made from a seed, go through both packages.  The
reference's ``ops.ssd(impl='pallas')`` runs its Pallas kernel in
interpret mode on the CPU.

On the CPU ``ops.ssd`` runs the kernel's plain version; the CUDA kernel
itself is held against that plain version on the card by
``chip_smoke.py``.  Tolerances are the reference's own (its
``tests/test_kernels.py``): y to 2e-4 · max|y_ref| absolute, the final
state to 1e-4 absolute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests elsewhere must not starve
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ops as r_ops  # noqa: E402
from repro.kernels.ssd import ref as r_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as t_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as t_ref  # noqa: E402


def _inputs(seed, Bb=2, L=64, H=4, P=8, G=2, N=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(Bb, L, H, P).astype(np.float32)
    dt = (np.abs(rng.randn(Bb, L, H)) * 0.1 + 0.01).astype(np.float32)
    A = -(np.abs(rng.randn(H)) + 0.5).astype(np.float32)
    B = rng.randn(Bb, L, G, N).astype(np.float32)
    C = rng.randn(Bb, L, G, N).astype(np.float32)
    return x, dt, A, B, C


def T(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def J(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want):
    (y, S), (y_ref, S_ref) = got, want
    y_ref, S_ref = np.asarray(y_ref), np.asarray(S_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=2e-4 * float(np.max(np.abs(y_ref))))
    np.testing.assert_allclose(np.asarray(S), S_ref, atol=1e-4)


@pytest.mark.parametrize("G", [1, 2])
def test_scan_ref_matches_reference(G):
    ins = _inputs(0, L=24, G=G)
    _close(t_ref.ssd_scan_ref(*T(*ins)), r_ref.ssd_scan_ref(*J(*ins)))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_ref_matches_reference(G, chunk):
    ins = _inputs(1, G=G)
    _close(
        t_ref.ssd_chunked_ref(*T(*ins), chunk=chunk),
        r_ref.ssd_chunked_ref(*J(*ins), chunk=chunk),
    )
    _close(t_ref.ssd_chunked_ref(*T(*ins), chunk=chunk), r_ref.ssd_scan_ref(*J(*ins)))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("L", [64, 77])
def test_ssd_op_matches_reference_pallas(G, chunk, L):
    """The kernel route (CPU: the plain version) against the reference's
    Pallas kernel, padding included when L is ragged."""
    ins = _inputs(2, L=L, G=G)
    got = t_ops.ssd(*T(*ins), chunk=chunk)
    assert got[0].shape == (2, L, 4, 8) and got[1].shape == (2, 4, 8, 8)
    _close(got, r_ops.ssd(*J(*ins), chunk=chunk, impl="pallas"))
    _close(got, r_ref.ssd_scan_ref(*J(*ins)))


def test_decode_step_matches_reference():
    ins = _inputs(3, L=24)
    x, dt, A, B, C = T(*ins)
    S_t = torch.zeros(2, 4, 8, 8)
    S_r = jnp.zeros((2, 4, 8, 8))
    xr, dtr, Ar, Br, Cr = J(*ins)
    ys_t, ys_r = [], []
    for t in range(x.shape[1]):
        S_t, y_t = t_ops.ssd_decode_step(S_t, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        S_r, y_r = r_ops.ssd_decode_step(S_r, xr[:, t], dtr[:, t], Ar, Br[:, t], Cr[:, t])
        ys_t.append(y_t)
        ys_r.append(y_r)
    _close((torch.stack(ys_t, 1), S_t), (jnp.stack(ys_r, 1), S_r))
    _close((torch.stack(ys_t, 1), S_t), r_ref.ssd_scan_ref(*J(*ins)))


def test_initial_state_composition_on_chunked_route():
    """Splitting L and chaining initial_state equals one pass, and the
    port's chunked route takes the reference's initial state as given."""
    ins = _inputs(4, L=64)
    x, dt, A, B, C = T(*ins)
    whole = t_ops.ssd(x, dt, A, B, C, chunk=16, impl="chunked")
    y1, S1 = t_ops.ssd(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32], chunk=16, impl="chunked")
    y2, S2 = t_ops.ssd(
        x[:, 32:], dt[:, 32:], A, B[:, 32:], C[:, 32:], chunk=16, impl="chunked",
        initial_state=S1,
    )
    _close((torch.cat([y1, y2], 1), S2), whole)
    xr, dtr, Ar, Br, Cr = J(*ins)
    _, S1r = r_ops.ssd(xr[:, :32], dtr[:, :32], Ar, Br[:, :32], Cr[:, :32], chunk=16, impl="jnp")
    ref2 = r_ops.ssd(
        xr[:, 32:], dtr[:, 32:], Ar, Br[:, 32:], Cr[:, 32:], chunk=16, impl="jnp",
        initial_state=S1r,
    )
    _close((y2, S2), ref2)


def test_kernel_route_rejects_initial_state():
    x, dt, A, B, C = T(*_inputs(5, L=32))
    with pytest.raises(NotImplementedError, match="initial_state"):
        t_ops.ssd(x, dt, A, B, C, chunk=16, initial_state=torch.zeros(2, 4, 8, 8))
    with pytest.raises(ValueError, match="unknown impl"):
        t_ops.ssd(x, dt, A, B, C, chunk=16, impl="pallas")


def test_mask_precedes_exp_where_decay_overflows():
    """Strong decay makes exp(seg_i − seg_j) overflow to inf above the
    diagonal; masked before the exp, the chunked form stays finite and
    equal to the exact scan (inf·0 would have been NaN)."""
    ins = list(_inputs(6, L=32, H=2, G=1))
    ins[1] = np.full_like(ins[1], 4.0)  # dt
    ins[2] = np.array([-16.0, -8.0], np.float32)  # A: seg falls 64 per step
    y, S = t_ref.ssd_chunked_ref(*T(*ins), chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    _close((y, S), t_ref.ssd_scan_ref(*T(*ins)))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """Routing is by the tensor's device: a CPU tensor never reaches the
    CUDA wrapper, and the wrapper refuses anything but CUDA tensors."""

    def no_kernel(*a, **k):
        raise AssertionError("the CUDA kernel was called for CPU tensors")

    monkeypatch.setattr(t_kernel, "ssd_chunked_cuda", no_kernel)
    x, dt, A, B, C = T(*_inputs(7, L=32))
    y, S = t_ops.ssd(x, dt, A, B, C, chunk=16)
    assert y.device.type == "cpu" and torch.isfinite(y).all()
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kernel.ssd_chunked_cuda(x, dt, A, B, C, 16)
    assert t_kernel.ssd_chunked_cuda.launches == 0


# -- B5's three-pass decomposition (ref.ssd_three_pass_ref) ---------------------


def _padded(ins, chunk):
    """Pad L up to a chunk multiple with dt = 0, as ops.ssd does."""
    pad = (-ins[0].shape[1]) % chunk
    widths = lambda a: [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)  # noqa: E731
    x, dt, A, B, C = ins
    return [np.pad(x, widths(x)), np.pad(dt, widths(dt)), A, np.pad(B, widths(B)), np.pad(C, widths(C))]


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L", [64, 77])
@pytest.mark.parametrize("Bb,H", [(2, 4), (1, 2)])
def test_three_pass_matches_chunked_ref_and_reference_pallas(G, L, Bb, H):
    """Chunk states, state passing and chunk scan together equal the plain
    chunked form and the reference's Pallas kernel, L padded up to a chunk
    multiple, Bb·H far below the card's 132 SMs (the case the chunk-parallel
    split exists for)."""
    ins = _inputs(8, Bb=Bb, L=L, H=H, G=min(G, H))
    chunk = 16
    y, S = t_ref.ssd_three_pass_ref(*T(*_padded(ins, chunk)), chunk)
    y = y[:, :L]
    want = t_ref.ssd_chunked_ref(*T(*_padded(ins, chunk)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), want[0][:, :L].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(S.numpy(), want[1].numpy(), rtol=1e-5, atol=1e-5)
    _close((y, S), r_ops.ssd(*J(*ins), chunk=chunk, impl="pallas"))


def test_three_pass_workspace_and_passes():
    """Pass 1's outputs fill exactly the wrapper's workspace; pass 2's
    entering states start at zero and chain by the chunk decay; the final
    state is the plain version's."""
    ins = T(*_inputs(9, L=48))
    x, dt, A, B, C = ins
    seg, dS = t_ref.ssd_chunk_states_ref(x, dt, A, B, 16)
    Bb, L, H, P = x.shape
    assert seg.shape == (Bb, H, 3, 16) and dS.shape == (Bb, H, 3, P, 8)
    assert seg.numel() + dS.numel() == t_kernel.ssd_workspace_floats(Bb, H, 3, 16, P, 8)
    S_in, S = t_ref.ssd_state_passing_ref(dS, seg)
    assert torch.equal(S_in[:, :, 0], torch.zeros_like(S))
    torch.testing.assert_close(S_in[:, :, 1], dS[:, :, 0])
    torch.testing.assert_close(
        S_in[:, :, 2], torch.exp(seg[:, :, 1, -1])[..., None, None] * dS[:, :, 0] + dS[:, :, 1]
    )
    _close((x, S), (x, t_ref.ssd_chunked_ref(*ins, chunk=16)[1]))


def test_three_pass_mask_precedes_exp_under_strong_decay():
    ins = list(_inputs(6, L=32, H=2, G=1))
    ins[1] = np.full_like(ins[1], 4.0)
    ins[2] = np.array([-16.0, -8.0], np.float32)
    y, S = t_ref.ssd_three_pass_ref(*T(*ins), 16)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    _close((y, S), t_ref.ssd_scan_ref(*T(*ins)))


# -- 3×TF32: the kernel's product arithmetic, emulated --------------------------


def _tf32(a):
    """The kernel's high part: round to the nearest value with 10 explicit
    mantissa bits, ties away from zero (as cvt.rna.tf32.f32 rounds finite
    inputs)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a):
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _mma_3xtf32(a, b):
    """a (M, K) · b (K, N) as the kernel forms it: each operand split into
    its rounded TF32 high part and the float32 rest (read truncated), per
    k step of 8 three m16n8k8 products (lo·hi, hi·lo, hi·hi; exact
    products) added to a float32 accumulator."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_trunc(a - a_hi), _tf32_trunc(b - b_hi)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for u, v in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            acc = (acc.astype(np.float64) + u[:, s].astype(np.float64) @ v[s].astype(np.float64)).astype(np.float32)
    return acc


def test_3xtf32_products_keep_float32_accuracy():
    """One chunk's four products at mamba2-370m's (Q, P, N) = (128, 64,
    128), on magnitudes like a layer's (decayed scores, dt-scaled x, a
    carried state): the split's result is within 1e-6 relative L2 of
    float64, while TF32 alone is not (so the bound is the split's)."""
    Q, P, N = 128, 64, 128
    rng = np.random.RandomState(10)
    Cm, Bm = rng.randn(Q, N).astype(np.float32), rng.randn(Q, N).astype(np.float32)
    X = (rng.randn(Q, P) * 0.05).astype(np.float32)
    S_in = (rng.randn(P, N) * 3.0).astype(np.float32)
    seg = np.cumsum(-np.abs(rng.randn(Q)) * 0.05).astype(np.float32)
    decay = np.tril(np.exp(seg[:, None] - seg[None, :])).astype(np.float32)
    scores = (Cm.astype(np.float64) @ Bm.T.astype(np.float64)).astype(np.float32) * decay
    for a, b in ((Cm, Bm.T), (scores, X), (Cm, S_in.T), (X.T, Bm)):
        exact = a.astype(np.float64) @ b.astype(np.float64)
        rel = np.linalg.norm(_mma_3xtf32(a, b) - exact) / np.linalg.norm(exact)
        assert rel < 1e-6, rel
        one = _tf32(a).astype(np.float64) @ _tf32(b).astype(np.float64)
        assert np.linalg.norm(one - exact) / np.linalg.norm(exact) > 1e-5
    assert _tf32(np.float32(1 + 2**-11)) == np.float32(1 + 2**-10)  # a tie rounds away
    assert _tf32(np.float32(-(1 + 2**-11))) == np.float32(-(1 + 2**-10))


@pytest.mark.parametrize(
    "Bb,nc,H,G", [(4, 16, 32, 1), (2, 8, 32, 1), (1, 16, 32, 1), (2, 4, 4, 1), (8, 64, 32, 1), (2, 4, 8, 2), (1, 1, 6, 3)]
)
def test_scan_heads_plan_keeps_the_card_filled(Bb, nc, H, G):
    """The chunk scan walks runs of HB heads of one group: HB a power of
    two dividing H / G, the largest that keeps at least
    SCAN_MIN_BLOCKS_PER_SM blocks per SM of an H100 (132 SMs)."""
    sms = 132
    hb = t_kernel.scan_heads_per_block(Bb, nc, H, G, sms)
    assert hb & (hb - 1) == 0 and (H // G) % hb == 0
    assert hb == 1 or Bb * nc * H // hb >= t_kernel.SCAN_MIN_BLOCKS_PER_SM * sms
    assert (H // G) % (2 * hb) or Bb * nc * H // (2 * hb) < t_kernel.SCAN_MIN_BLOCKS_PER_SM * sms
    # the serving shapes: mamba2-370m's 32 heads in one group
    assert t_kernel.scan_heads_per_block(4, 16, 32, 1, sms) == 8
    assert t_kernel.scan_heads_per_block(2, 8, 32, 1, sms) == 2
