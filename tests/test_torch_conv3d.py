"""The port's direct-correlation op (kernel B4's plain version, the public
``conv3d`` and ``conv3d_strips``) against the JAX reference's: the same
numpy inputs, made from a seed, go through both packages.  The
reference's ``ops.conv3d`` runs its Pallas kernel in interpret mode on
the CPU, as ``tests/test_kernels.py`` runs it, at small shapes only: it
unrolls every tap, so the paper-geometry case (9,600 taps) is held
against the reference's ``conv3d_ref`` (a lax.conv) alone.

On the CPU ``ops.conv3d`` runs the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py``.  What the CPU can check of the kernel is its launch
plan (``kernel.plan``): that the tiles cover every output exactly once
and fit the card's limits.

Tolerances: float32 sums of at most a few hundred products (the sweep)
agree to 1e-5 of the largest output; the paper-geometry clip's 9,600-tap
sums to relative L2 1e-5; bfloat16 outputs, each a float32 sum rounded
once to bfloat16, to relative L2 1e-2 (one bfloat16 step is 2^-8).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests elsewhere must not starve
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.conv3d import ops as r_ops  # noqa: E402
from repro.kernels.conv3d import ref as r_ref  # noqa: E402
from repro_torch.kernels.conv3d import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.conv3d import ops as t_ops  # noqa: E402
from repro_torch.kernels.conv3d import ref as t_ref  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference test's sweep (b 1–2, c 1–4, o 1–6, k 1–3, h 6–14, t 4–10;
# x (b, c, h, h+2, t), w (o, c, k, k, min(k, t))), enumerated instead of
# drawn: every value of each axis appears
SWEEP = [
    (1, 1, 1, 1, 6, 4),
    (2, 4, 6, 3, 14, 10),
    (1, 3, 2, 2, 9, 5),
    (2, 2, 5, 3, 7, 7),
    (1, 4, 3, 1, 12, 9),
    (2, 1, 4, 2, 11, 6),
    (1, 2, 6, 3, 8, 8),
    (2, 3, 1, 2, 13, 4),
]


def _inputs(b, c, o, k, h, t):
    rng = np.random.RandomState(h * 10 + t)
    x = rng.randn(b, c, h, h + 2, t).astype(np.float32)
    w = rng.randn(o, c, k, k, min(k, t)).astype(np.float32)
    return x, w


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("b,c,o,k,h,t", SWEEP)
def test_conv3d_matches_reference_pallas_and_oracle(b, c, o, k, h, t):
    x, w = _inputs(b, c, o, k, h, t)
    got = t_ops.conv3d(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want_k = np.asarray(r_ops.conv3d(jnp.asarray(x), jnp.asarray(w)))
    want_r = np.asarray(r_ref.conv3d_ref(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == want_k.shape == want_r.shape
    assert got.dtype == np.float32
    tol = 1e-5 * float(np.max(np.abs(want_r)))
    np.testing.assert_allclose(got, want_k, rtol=0, atol=tol)
    np.testing.assert_allclose(got, want_r, rtol=0, atol=tol)


def test_conv3d_bf16_matches_reference_pallas():
    x, w = _inputs(2, 3, 4, 3, 10, 8)
    xb, wb = x.astype(ml_dtypes.bfloat16), w.astype(ml_dtypes.bfloat16)
    got = t_ops.conv3d(
        torch.from_numpy(xb.view(np.int16)).view(torch.bfloat16),
        torch.from_numpy(wb.view(np.int16)).view(torch.bfloat16),
    )
    assert got.dtype == torch.bfloat16
    want = np.asarray(r_ops.conv3d(jnp.asarray(xb), jnp.asarray(wb)))
    assert want.dtype == ml_dtypes.bfloat16
    assert _rel_l2(got.float().numpy(), want.astype(np.float32)) <= 1e-2


@pytest.mark.parametrize("strip_h", [4, 7, 18])
def test_conv3d_strips_match(strip_h):
    rng = np.random.RandomState(1)
    x = rng.randn(1, 3, 20, 16, 8).astype(np.float32)
    w = rng.randn(4, 3, 3, 3, 3).astype(np.float32)
    want = np.asarray(r_ref.conv3d_ref(jnp.asarray(x), jnp.asarray(w)))
    got = t_ops.conv3d_strips(torch.from_numpy(x), torch.from_numpy(w), strip_h=strip_h)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * float(np.max(np.abs(want))))


def test_conv3d_paper_geometry_matches_oracle():
    rng = np.random.RandomState(7)
    x = rng.rand(1, 1, 60, 80, 16).astype(np.float32)
    w = rng.randn(9, 1, 30, 40, 8).astype(np.float32)
    got = t_ops.conv3d(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(r_ref.conv3d_ref(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == (1, 9, 31, 41, 9)
    assert _rel_l2(got, want) <= 1e-5


def test_kernel_refuses_cpu_tensors_and_ops_refuses_other_devices():
    x = torch.zeros(1, 1, 6, 6, 4)
    w = torch.zeros(2, 1, 3, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.conv3d_cuda(x, w)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        t_ops.conv3d(x.to("meta"), w.to("meta"))
    assert t_kernel.conv3d_cuda.launches == 0


def test_kernel_module_imports_without_nvcc():
    env = dict(
        os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent",
        PYTHONPATH=os.path.join(REPO, "src"),
    )
    code = (
        "from repro_torch.kernels.conv3d import kernel\n"
        "assert kernel._LIB._lib is None\n"
        "print(kernel.plan((16, 1, 60, 80, 16), (9, 1, 30, 40, 8)))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Plan(" in proc.stdout


def _coverage(x_shape, w_shape, p):
    """How often the plan's threads store each output (every thread owns
    ob channels x rt frames at one (row, column)), as csrc/conv3d.cu maps
    blocks and threads."""
    B, _, H, W, T = x_shape
    O, _, kh, kw, kt = w_shape
    OH, OW, OT = H - kh + 1, W - kw + 1, T - kt + 1
    ng, nh, nw = -(-O // p.ob), -(-OH // p.bh), -(-OW // p.bw)
    nt = -(-OT // (p.ntt * p.rt))
    assert B * ng * nh * nw * nt == p.blocks
    bid, tid = np.meshgrid(np.arange(p.blocks), np.arange(p.threads), indexing="ij")
    tb, rest = bid % nt, bid // nt
    wb, rest = rest % nw, rest // nw
    hb, rest = rest % nh, rest // nh
    gi, b = rest % ng, rest // ng
    tt, owl, ohl = tid % p.ntt, (tid // p.ntt) % p.bw, tid // (p.ntt * p.bw)
    oh, ow = hb * p.bh + ohl, wb * p.bw + owl
    ot = tb * p.ntt * p.rt + tt * p.rt
    active = (ohl < p.bh) & (oh < OH) & (ow < OW) & (ot < OT)
    count = np.zeros((B, O, OH, OW, OT), np.int64)
    for o in range(p.ob):
        for j in range(p.rt):
            m = active & (gi * p.ob + o < O) & (ot + j < OT)
            np.add.at(count, (b[m], gi[m] * p.ob + o, oh[m], ow[m], ot[m] + j), 1)
    return count


@pytest.mark.parametrize(
    "x_shape,w_shape",
    [
        ((16, 1, 60, 80, 16), (9, 1, 30, 40, 8)),  # the serving batch
        ((4, 1, 60, 80, 512), (9, 1, 30, 40, 8)),  # four 512-frame streams
        ((1, 16, 14, 14, 8), (16, 16, 3, 3, 3)),  # kernels_bench's C3D case
        ((2, 4, 14, 16, 10), (6, 4, 3, 3, 3)),  # the test sweep's largest
        ((1, 1, 20, 24, 10), (3, 1, 7, 9, 4)),  # the smoke config
    ],
)
def test_plan_covers_every_output_once_within_limits(x_shape, w_shape):
    p = t_kernel.plan(x_shape, w_shape)
    assert p.ob in t_kernel.OB_CHOICES and p.rt in t_kernel.RT_CHOICES
    assert p.bh * p.bw * p.ntt <= p.threads <= t_kernel.MAX_THREADS
    assert p.threads % 32 == 0
    assert p.smem <= t_kernel.MAX_SMEM
    assert (_coverage(x_shape, w_shape, p) == 1).all()


def test_plan_spreads_the_serving_batch_over_the_card():
    p = t_kernel.plan((16, 1, 60, 80, 16), (9, 1, 30, 40, 8))
    assert (p.ob, p.rt) == (9, 3)  # one channel group, three frame tiles
    assert p.blocks >= 2 * t_kernel.SMS


def test_plan_refuses_a_kernel_row_over_shared_memory():
    with pytest.raises(ValueError, match="shared"):
        t_kernel.plan((1, 1, 4, 300, 300), (9, 1, 1, 200, 200))


def test_flops_of_the_serving_batch():
    assert t_kernel.flops((16, 1, 60, 80, 16), (9, 1, 30, 40, 8)) == 2 * 16 * 102_951 * 9_600
