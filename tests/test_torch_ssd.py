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
