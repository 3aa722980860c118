"""The port's flash-attention op (kernel B6's plain version and the public
``flash_attention``, its autograd backward included) against the JAX
reference's: the same numpy inputs, made from a seed, go through both
packages.  The reference's ``ops.flash_attention`` runs its Pallas
kernel in interpret mode on the CPU, as ``tests/test_flash.py`` runs it.

On the CPU ``ops.flash_attention`` runs the kernel's plain version; the
CUDA kernels themselves are held against that plain version on the card
by ``chip_smoke.py``.  Tolerances are the reference test's own: 3e-5
absolute for the forward, 1e-4 for the gradients; bf16 by relative L2
2e-2 (the frameworks round bf16 at different places).

What the CPU can check of the kernels: which build serves each (dtype,
head dim), the shared memory each plans, the wrapper's refusals, and the
bf16 tensor-core kernel's arithmetic (64-row tiles, base-2 scores, p
rounded to bf16, l of the unrounded p), written out here in float32 and
held against the reference's Pallas kernel and, with ``chip_smoke.py``'s
bounds, against the plain version on float32 inputs.
"""

import itertools
import math
import os
import re

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


def test_routes_send_bf16_to_the_wgmma_kernel():
    assert set(t_kernel.ROUTES) == set(itertools.product(t_kernel.DTYPES, t_kernel.HEAD_DIMS))
    for (dtype, d), route in t_kernel.ROUTES.items():
        assert route == ("wgmma" if dtype == torch.bfloat16 else "fma"), (dtype, d)


def test_head_dims_and_dtypes_unchanged():
    assert t_kernel.HEAD_DIMS == (16, 24, 32, 128)
    assert t_kernel.DTYPES == {torch.float32: 0, torch.bfloat16: 1}


@pytest.mark.parametrize("dtype,d", list(itertools.product((torch.float32, torch.bfloat16), (16, 24, 32, 128))))
def test_smem_plan_fits_one_block(dtype, d):
    """Every build's dynamic shared memory fits one block (227 KB), and
    two blocks of it fit one SM's 228 KB (each block holds 1 KB more)."""
    n = t_kernel.smem_bytes(dtype, d)
    assert 0 < n <= t_kernel.SMEM_PER_BLOCK
    assert 2 * (n + 1024) <= 228 * 1024
    if dtype == torch.bfloat16:  # bf16 rows padded to 16: 24 plans as 32
        dp = -(-d // 16) * 16
        assert n == 2 * dp * (64 + 2 * t_kernel.WGMMA_STAGES * 64) + 1024


def test_plan_mirrors_the_cuda_sources():
    """kernel.py's tile constants are the ones the CUDA sources compile."""
    csrc = os.path.join(os.path.dirname(t_kernel.__file__), "csrc")
    with open(os.path.join(csrc, "flash_wgmma.cu")) as fh:
        wg = fh.read()
    with open(os.path.join(csrc, "flash.cu")) as fh:
        fma = fh.read()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = ([0-9]+);", src).group(1))

    assert const(wg, "kStages") == t_kernel.WGMMA_STAGES
    assert const(wg, "kAlign") == 1024
    assert const(wg, "BK") == const(wg, "BQ") == const(fma, "BK") == const(fma, "BQ") == t_kernel.BK == t_kernel.BQ
    for d in t_kernel.HEAD_DIMS:
        assert f"case {d}: return launch<{d}>" in wg and f"case {d}: return launch<{d}>" in fma


def _misaligned(shape):
    flat = torch.zeros(math.prod(shape) + 8, dtype=torch.bfloat16)
    return flat[1 : 1 + math.prod(shape)].view(shape)


_REFUSALS = {
    "cpu tensor": (lambda: T(*_qkv(4, 1, 16, 16, 2, 1, 16)), "CUDA tensor"),
    "bad dtype": (lambda: [t.half() for t in T(*_qkv(4, 1, 16, 16, 2, 1, 16))], "no kernel for dtype"),
    "mixed dtypes": (
        lambda: [t.to(torch.bfloat16) if i else t for i, t in enumerate(T(*_qkv(4, 1, 16, 16, 2, 1, 16)))],
        "must be torch.float32",
    ),
    "misaligned pointer": (
        lambda: [_misaligned((1, 16, 2, 16))] + [t.to(torch.bfloat16) for t in T(*_qkv(4, 1, 16, 16, 2, 1, 16))[1:]],
        "16-byte boundary",
    ),
    "unknown head dim": (lambda: T(*_qkv(4, 1, 16, 16, 2, 1, 64)), "no kernel for head dim"),
    "kv heads do not divide": (lambda: T(*_qkv(4, 1, 16, 16, 3, 2, 16)), "do not split"),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_wrapper_refuses(case):
    make, match = _REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        t_kernel.flash_fwd_cuda(*make())
    assert t_kernel.flash_fwd_cuda.launches == 0


def _wgmma_kernel_arithmetic(q, k, v, causal, scale=None):
    """The bf16 wgmma kernel's arithmetic, in float32 on the CPU:
    64-query and 64-key tiles, the kv loop ending at the causal diagonal,
    float32 scores in base-2 units (s · scale · log2 e) with −1e30 masks
    and m starting at −1e30, p = 2^(x − m) rounded to bf16 for the p·v
    product while l sums the unrounded p, o = acc / max(l, 1e-30) in bf16."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32
    )
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, Sq, D)
    kf = k.float().repeat_interleave(H // G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(H // G, dim=2).permute(0, 2, 1, 3)
    out = torch.empty_like(qf)
    for q0 in range(0, Sq, 64):
        qt = qf[:, :, q0 : q0 + 64]
        qpos = torch.arange(q0, q0 + qt.shape[2])[:, None]
        last = min(Sk - 1, q0 + 63) if causal else Sk - 1
        m = torch.full(qt.shape[:3], -1e30)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for k0 in range(0, last + 1, 64):
            x = (qt @ kf[:, :, k0 : k0 + 64].transpose(-1, -2)) * sl2
            kpos = torch.arange(k0, k0 + x.shape[-1])[None, :]
            x = torch.where((kpos >= Sk) | (causal & (qpos < kpos)), torch.tensor(-1e30), x)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, k0 : k0 + 64]
            m = m_new
        out[:, :, q0 : q0 + 64] = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


# chip_smoke.py's bf16 bounds against the plain version on float32 inputs
ROW_RTOL, ABS_V = 1e-2, 5e-3
# a sample of chip_smoke.py's bf16 sweep (B, Sq, Sk, H, G, D, causal)
BF16_SWEEP = [
    (2, 37, 37, 4, 4, 16, True), (2, 37, 37, 4, 2, 16, False), (1, 40, 100, 4, 2, 16, False),
    (1, 40, 100, 4, 2, 16, True), (1, 100, 40, 4, 2, 32, True), (2, 71, 71, 6, 1, 32, False),
    (2, 130, 130, 6, 1, 24, False), (1, 300, 300, 4, 4, 128, True),
]


@pytest.mark.parametrize("B,Sq,Sk,H,G,D,causal", BF16_SWEEP)
def test_wgmma_arithmetic_matches_reference_pallas(B, Sq, Sk, H, G, D, causal):
    ins = _qkv(Sq + 7 * H + D, B, Sq, Sk, H, G, D)
    tb = [t.to(torch.bfloat16) for t in T(*ins)]
    got = _wgmma_kernel_arithmetic(*tb, causal).float()
    want = np.asarray(
        r_ops.flash_attention(*[a.astype(jnp.bfloat16) for a in J(*ins)], causal, None), np.float32
    )
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel
    # the bounds chip_smoke.py holds the kernel to, here on its arithmetic
    exact = t_ref.flash_ref(*[t.float() for t in tb], causal=causal)
    err = (got - exact).reshape(-1, D)
    row = torch.linalg.vector_norm(err, dim=1) / torch.linalg.vector_norm(exact.reshape(-1, D), dim=1)
    assert float(row.max()) <= ROW_RTOL, float(row.max())
    assert float(err.abs().max()) <= ABS_V * float(tb[2].float().abs().max())
