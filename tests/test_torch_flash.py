"""The port's flash-attention op (kernel B6's plain version and the public
``flash_attention``, its autograd backward included) against the JAX
reference's: the same numpy inputs, made from a seed, go through both
packages.  The reference's ``ops.flash_attention`` runs its Pallas
kernel in interpret mode on the CPU, as ``tests/test_flash.py`` runs it.

On the CPU ``ops.flash_attention`` runs the kernel's plain version; the
CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py``.  Tolerances are the reference test's own: 3e-5
absolute for the forward, 1e-4 for the gradients; bf16 by relative L2
2e-2 (the frameworks round bf16 at different places).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests elsewhere must not starve
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash import ops as r_ops  # noqa: E402
from repro.kernels.flash import ref as r_ref  # noqa: E402
from repro_torch.kernels.flash import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash import ref as t_ref  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402

# the reference test's sweep (Sq 4–96, h in {2, 4, 8}, G in {h, h/2},
# d in {16, 32}, both mask settings), enumerated instead of drawn
SWEEP = [
    (sq, h, gdiv, 16 if (sq + h + gdiv) % 2 else 32, causal)
    for sq, h, gdiv, causal in itertools.product((4, 37, 96), (2, 4, 8), (1, 2), (True, False))
]


def _qkv(seed, B, Sq, Sk, H, G, D):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(B, Sq, H, D).astype(np.float32),
        rng.randn(B, Sk, G, D).astype(np.float32),
        rng.randn(B, Sk, G, D).astype(np.float32),
    )


def T(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def J(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("sq,h,gdiv,d,causal", SWEEP)
def test_flash_matches_reference_pallas(sq, h, gdiv, d, causal):
    ins = _qkv(sq * 10 + h, 2, sq, sq, h, h // gdiv, d)
    got = t_ops.flash_attention(*T(*ins), causal, None)
    assert got.shape == (2, sq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(r_ops.flash_attention(*J(*ins), causal, None)), atol=3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(r_ref.flash_ref(*J(*ins), causal=causal)), atol=3e-5)


def test_flash_cross_lengths():
    """Sq != Sk (cross attention / padded cache), non-causal."""
    ins = _qkv(0, 1, 40, 100, 4, 2, 16)
    got = t_ops.flash_attention(*T(*ins), False, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(r_ops.flash_attention(*J(*ins), False, None)), atol=3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(r_ref.flash_ref(*J(*ins), causal=False)), atol=3e-5)


def test_flash_softmax_scale_and_bf16():
    """An explicit scale, and bf16 inputs: the plain version scales q in
    bf16 before its float32-accumulated dot, as the reference does."""
    ins = _qkv(1, 2, 48, 48, 4, 2, 32)
    got = t_ops.flash_attention(*T(*ins), True, 0.3)
    want = np.asarray(r_ref.flash_ref(*J(*ins), causal=True, softmax_scale=0.3))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    tb = [t.to(torch.bfloat16) for t in T(*ins)]
    jb = [a.astype(jnp.bfloat16) for a in J(*ins)]
    got = t_ops.flash_attention(*tb, True, None)
    assert got.dtype == torch.bfloat16
    want = np.asarray(r_ops.flash_attention(*jb, True, None), np.float32)
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel


def test_flash_gradients_match_reference():
    """The autograd backward (recomputed through the plain version)
    against ``jax.grad`` of the reference's custom-vjp op."""
    ins = _qkv(1, 1, 32, 32, 4, 2, 16)
    tq, tk, tv = (t.requires_grad_() for t in T(*ins))
    torch.sum(t_ops.flash_attention(tq, tk, tv, True, None) ** 2).backward()

    def loss(q, k, v):
        return jnp.sum(r_ops.flash_attention(q, k, v, True, None) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*J(*ins))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4)


def test_ref_is_the_blockwise_attention():
    ins = T(*_qkv(2, 2, 20, 20, 4, 4, 16))
    assert torch.equal(t_ref.flash_ref(*ins), t_common.blockwise_attention(*ins))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """Routing is by the tensor's device: a CPU tensor never reaches the
    CUDA wrapper, and the wrapper refuses anything but CUDA tensors of
    an instantiated dtype."""

    def no_kernel(*a, **k):
        raise AssertionError("the CUDA kernel was called for CPU tensors")

    monkeypatch.setattr(t_kernel, "flash_fwd_cuda", no_kernel)
    q, k, v = T(*_qkv(3, 1, 16, 16, 2, 1, 16))
    out = t_ops.flash_attention(q, k, v)
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kernel.flash_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="no kernel for dtype"):
        t_kernel.flash_fwd_cuda(q.half(), k.half(), v.half())
    assert t_kernel.flash_fwd_cuda.launches == 0
    assert t_kernel.HEAD_DIMS == (16, 24, 32, 128)
