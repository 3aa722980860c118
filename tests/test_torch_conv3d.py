"""The port's direct-correlation op (kernel B4's plain version, the public
``conv3d`` and ``conv3d_strips``) against the JAX reference's: the same
numpy inputs, made from a seed, go through both packages.  The
reference's ``ops.conv3d`` runs its Pallas kernel in interpret mode on
the CPU, as ``tests/test_kernels.py`` runs it, at small shapes only: it
unrolls every tap, so the paper-geometry case (9,600 taps) is held
against the reference's ``conv3d_ref`` (a lax.conv) alone.

On the CPU ``ops.conv3d`` runs the kernel's plain version, and its
gradients (an autograd function whose backward recomputes through the
plain version) are held against ``jax.vjp`` of the reference's
``direct_correlate3d``; the CUDA
kernels themselves are held against that plain version on the card by
``chip_smoke.py``.  What the CPU can check of them is which one a call
takes (``kernel.route``), their launch plans (``kernel.plan`` for the
FMA kernel, ``kernel.tc_plan`` for the tensor-core kernel): that the
tiles cover every output exactly once and fit the card's limits; and the
tensor-core kernel's 3xTF32 arithmetic, through its CPU model
``ref.conv3d_3xtf32_ref``.

Tolerances: float32 sums of at most a few hundred products (the sweep)
agree to 1e-5 of the largest output; the paper-geometry clip's 9,600-tap
sums to relative L2 1e-5; bfloat16 outputs, each a float32 sum rounded
once to bfloat16, to relative L2 1e-2 (one bfloat16 step is 2^-8).  The
3xTF32 model keeps float32 accuracy: within 1e-6 relative L2 of float64
(the dropped lo·lo is ~2^-22 of each product), where TF32 alone is off
by ~3e-4.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests elsewhere must not starve
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import spectral_conv as r_sc  # noqa: E402
from repro.kernels.conv3d import ops as r_ops  # noqa: E402
from repro.kernels.conv3d import ref as r_ref  # noqa: E402
from repro_torch.kernels.conv3d import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.conv3d import ops as t_ops  # noqa: E402
from repro_torch.kernels.conv3d import ref as t_ref  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV_RTOL = 1e-5  # relative L2 that chip_smoke.py holds B4 to in float32
BATCH = ((16, 1, 60, 80, 16), (9, 1, 30, 40, 8))  # the serving batch
STREAMS = ((4, 1, 60, 80, 512), (9, 1, 30, 40, 8))  # four 512-frame streams
# C3D's convolutions (conv1a ... conv5b): input channels, filters, side, frames
C3D_LAYERS = [(3, 64, 112, 16), (64, 128, 56, 16), (128, 256, 28, 8), (256, 256, 28, 8),
              (256, 512, 14, 4), (512, 512, 14, 4), (512, 512, 7, 2), (512, 512, 7, 2)]

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


GRAD_CASES = [SWEEP[1], SWEEP[3], SWEEP[6], (3, 1, 4, 7, 20, 10)]


@pytest.mark.parametrize("b,c,o,k,h,t", GRAD_CASES)
@pytest.mark.parametrize("wrt", ["x and w", "w"])
def test_conv3d_gradients_match_plain_autograd_and_reference(b, c, o, k, h, t, wrt):
    """``ops.conv3d`` is an autograd function whose backward recomputes
    through the plain version: on the CPU its gradients equal autograd of
    ``conv3d_ref`` exactly, and are within 1e-5 (relative L2) of
    ``jax.vjp`` of the reference's ``direct_correlate3d``."""
    x, w = _inputs(b, c, o, k, h, t)
    want_y = np.asarray(r_sc.direct_correlate3d(jnp.asarray(x), jnp.asarray(w), "valid"))
    gy = np.random.RandomState(b + k).randn(*want_y.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, v: r_sc.direct_correlate3d(a, v, "valid"), jnp.asarray(x), jnp.asarray(w))
    want = dict(zip(("x", "w"), (np.asarray(v) for v in vjp(jnp.asarray(gy)))))

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_(wrt == "x and w")
        wt = torch.from_numpy(w).requires_grad_()
        y = fn(xt, wt)
        leaves = [xt, wt] if xt.requires_grad else [wt]
        out = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
        return dict(zip(("x", "w") if xt.requires_grad else ("w",), out)), y

    got, y = grads(t_ops.conv3d)
    plain, _ = grads(t_ref.conv3d_ref)
    assert y.grad_fn is not None and _rel_l2(y.detach().numpy(), want_y) <= CONV_RTOL
    assert set(got) == ({"x", "w"} if wrt == "x and w" else {"w"})
    for name, g in got.items():
        assert torch.equal(g, plain[name]), name
        assert _rel_l2(g.numpy(), want[name]) <= CONV_RTOL, name


def test_kernel_refuses_cpu_tensors_and_ops_refuses_other_devices():
    x = torch.zeros(1, 1, 6, 6, 4)
    w = torch.zeros(2, 1, 3, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.conv3d_cuda(x, w)
    # meta is the dry run's route (shapes alone); any other device raises
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        t_ops._forward(SimpleNamespace(device=torch.device("xpu")), w)
    y = t_ops.conv3d(x.to("meta"), w.to("meta"))
    assert y.device.type == "meta" and y.shape == (1, 2, 4, 4, 3) and y.dtype == x.dtype
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


# -- the tensor-core route ------------------------------------------------------


def test_3xtf32_model_keeps_float32_accuracy_at_the_paper_geometry():
    """One clip against 9 kernels of 30x40x8 (9,600-tap sums): the
    kernel's split arithmetic is within 1e-6 of float64 and within
    CONV_RTOL of the plain version, while TF32 alone is not within 1e-6
    (so the bound is the split's)."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.rand(1, 1, 60, 80, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(9, 1, 30, 40, 8).astype(np.float32))
    exact = torch.nn.functional.conv3d(x.double(), w.double()).numpy()
    got = t_ref.conv3d_3xtf32_ref(x, w)
    assert got.dtype == torch.float32 and got.shape == (1, 9, 31, 41, 9)
    assert _rel_l2(got.numpy(), exact) <= 1e-6
    assert _rel_l2(got.numpy(), t_ref.conv3d_ref(x, w).numpy()) <= CONV_RTOL
    xh, _ = t_ref.tf32_split(x)
    wh, _ = t_ref.tf32_split(w)
    tf32_only = torch.nn.functional.conv3d(xh.double(), wh.double()).numpy()
    assert _rel_l2(tf32_only, exact) > 1e-6


def _rz32(a):
    """float64 -> float32 rounded toward zero, as the tensor cores' float32
    accumulation rounds."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tensor_core_sum(x, w, row_steps):
    """One output channel's 9,600-tap sums as the tensor-core kernel forms
    them: per k step of 8 taps, x_hi·w_hi then x_lo·w_hi into one
    accumulator and x_hi·w_lo into another, each add rounded toward zero;
    every ``row_steps`` steps (0: never) both are added to a float32 sum
    and restart from zero."""
    xh, xl = (t.numpy().astype(np.float64) for t in t_ref.tf32_split(torch.from_numpy(x)))
    wh, wl = (t.numpy().astype(np.float64) for t in t_ref.tf32_split(torch.from_numpy(w)))
    total = np.zeros(x.shape[0], np.float32)
    acc, acc_lo = np.zeros_like(total), np.zeros_like(total)
    for s in range(x.shape[1] // 8):
        k = slice(8 * s, 8 * s + 8)
        acc = _rz32(acc + xh[:, k] @ wh[k])
        acc = _rz32(acc + xl[:, k] @ wh[k])
        acc_lo = _rz32(acc_lo + xh[:, k] @ wl[k])
        if row_steps and (s + 1) % row_steps == 0:
            total = total + acc + acc_lo
            acc[:], acc_lo[:] = 0, 0
    return total + acc + acc_lo


def test_row_sums_in_float32_keep_the_bound_under_truncating_accumulation():
    """The tensor cores round their float32 accumulation toward zero, so a
    sum over the paper geometry's 1,200 k steps drifts past CONV_RTOL;
    restarting each kernel row's 40 steps from zero and adding the rows in
    float32, as the kernel does, keeps it well inside."""
    rng = np.random.RandomState(11)
    x = rng.rand(400, 9600).astype(np.float32)
    w = rng.randn(9600).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    assert _rel_l2(_tensor_core_sum(x, w, 0), exact) > CONV_RTOL
    assert _rel_l2(_tensor_core_sum(x, w, 40), exact) <= CONV_RTOL / 3


def test_tf32_split_rounds_as_the_kernel():
    """hi keeps 10 explicit mantissa bits, rounded half away from zero;
    lo is the rest truncated to TF32; hi + lo is within 2^-21 of v."""
    v = torch.tensor([1.0 + 2**-11, -(1.0 + 2**-11), 1.0 + 2**-11 - 2**-23, 3.0, 1e-3, -7.25e5])
    hi, lo = t_ref.tf32_split(v)
    assert hi[0] == 1.0 + 2**-10 and hi[1] == -(1.0 + 2**-10)  # a tie goes away from zero
    assert hi[2] == 1.0  # below the tie rounds down
    assert hi[3] == 3.0 and lo[3] == 0.0
    bits = torch.cat([hi, lo]).view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()  # both are TF32 values
    assert (torch.abs(hi.double() + lo.double() - v.double()) <= 2**-21 * torch.abs(v.double())).all()


@pytest.mark.parametrize(
    "x_shape,w_shape,dtype,want",
    [
        (*BATCH, torch.float32, "wgmma"),
        (*STREAMS, torch.float32, "wgmma"),
        ((1, 1, 60, 80, 16), (9, 1, 30, 40, 8), torch.float32, "wgmma"),  # one clip
        (*BATCH, torch.bfloat16, "fma"),
        ((1, 16, 14, 14, 8), (16, 16, 3, 3, 3), torch.float32, "fma"),  # C3D, kt 3
        ((1, 16, 14, 14, 8), (16, 16, 3, 3, 3), torch.bfloat16, "fma"),
        ((1, 1, 60, 80, 16), (9, 1, 30, 40, 3), torch.float32, "fma"),  # kt 3
        ((1, 1, 20, 24, 10), (3, 1, 7, 9, 4), torch.float32, "fma"),  # the smoke config
        ((1, 1, 60, 80, 32), (9, 1, 30, 40, 16), torch.float32, "fma"),  # kt 16
        ((1, 1, 60, 80, 16), (10, 1, 30, 40, 8), torch.float32, "fma"),  # O over 9
        ((1, 1, 4, 300, 16), (9, 1, 1, 200, 8), torch.float32, "fma"),  # B over shared memory
    ]
    + [
        ((b, c, h, h + 2, t), (o, c, k, k, min(k, t)), torch.float32, "fma")
        for b, c, o, k, h, t in SWEEP
    ]
    + [  # C3D's eight layers, their inputs with the one-voxel border
        ((2, c, h + 2, h + 2, t + 2), (o, c, 3, 3, 3), torch.float32, "igemm")
        for c, o, h, t in C3D_LAYERS
    ]
    + [((2, 64, 58, 58, 18), (128, 64, 3, 3, 3), torch.bfloat16, "fma")],  # C3D's conv2a, bf16
)
def test_route_sends_the_main_shapes_to_tensor_cores(x_shape, w_shape, dtype, want):
    assert t_kernel.route(x_shape, w_shape, dtype) == want


def _tc_coverage(x_shape, w_shape, p):
    """How often the tensor-core kernel stores each output, as
    csrc/conv3d_tc.cu maps blocks, warpgroups, column tiles and tile rows
    (one tile row stores every channel)."""
    B, _, H, W, T = x_shape
    O, _, kh, kw, kt = w_shape
    OH, OW, OT = H - kh + 1, W - kw + 1, T - kt + 1
    cols = t_kernel.TC_NWG * t_kernel.TC_MT
    nib, njb, nkb = -(-OH // p.bi), -(-OW // cols), -(-OT // p.bk)
    assert B * nib * njb * nkb == p.blocks
    bid, tile, row = np.meshgrid(
        np.arange(p.blocks), np.arange(cols), np.arange(t_kernel.TC_ROWS), indexing="ij"
    )
    kb, rest = bid % nkb, bid // nkb
    jb, rest = rest % njb, rest // njb
    ib, b = rest % nib, rest // nib
    i = ib * p.bi + row // p.bk
    j = jb * cols + tile
    k = kb * p.bk + row % p.bk
    live = (row < p.bi * p.bk) & (i < OH) & (j < OW) & (k < OT)
    count = np.zeros((B, OH, OW, OT), np.int64)
    np.add.at(count, (b[live], i[live], j[live], k[live]), 1)
    return count


@pytest.mark.parametrize(
    "x_shape,w_shape",
    [
        BATCH,
        STREAMS,
        ((1, 1, 60, 80, 16), (9, 1, 30, 40, 8)),
        ((2, 2, 12, 20, 13), (9, 2, 3, 4, 8)),  # C 2, ragged T (not a multiple of 4)
        ((1, 1, 5, 18, 30), (5, 1, 2, 3, 8)),  # O 5, two output rows per tile
        ((1, 3, 40, 50, 70), (7, 3, 5, 9, 8)),  # OT 63: one frame run per tile
    ],
)
def test_tc_plan_covers_every_output_once_within_limits(x_shape, w_shape):
    p = t_kernel.tc_plan(x_shape, w_shape)
    assert 1 <= p.bi * p.bk <= t_kernel.TC_ROWS
    assert p.threads == t_kernel.TC_THREADS <= 1024
    assert p.smem <= t_kernel.MAX_SMEM
    assert p.blocks < 2**31
    assert (_tc_coverage(x_shape, w_shape, p) == 1).all()
    B, C, H, W, T = x_shape
    assert p.workspace_floats == 2 * B * C * H * W * (-(-T // 4) * 4) + C * int(
        np.prod(w_shape[2:4])
    ) * t_kernel.TC_STEP_FLOATS


def test_tc_plan_fills_the_card_at_the_main_shapes():
    """The batch: 7 output rows x 9 frames per tile (63 of 64 rows), 240
    blocks of one per SM; the streams: 64-frame runs, 2976 blocks."""
    pb, ps = t_kernel.tc_plan(*BATCH), t_kernel.tc_plan(*STREAMS)
    assert (pb.bi, pb.bk, pb.blocks) == (7, 9, 240)
    assert (ps.bi, ps.bk, ps.blocks) == (1, 64, 2976)
    assert min(pb.blocks, ps.blocks) >= t_kernel.SMS
    # two stages fit one block, not two, per SM
    assert t_kernel.MAX_SMEM // 2 < max(pb.smem, ps.smem) <= t_kernel.MAX_SMEM


def test_tc_plan_refuses_what_route_sends_elsewhere():
    with pytest.raises(ValueError, match="tensor-core"):
        t_kernel.tc_plan((1, 1, 60, 80, 16), (9, 1, 30, 40, 3))
    with pytest.raises(ValueError, match="tensor-core"):
        t_kernel.tc_plan((1, 1, 60, 80, 16), (10, 1, 30, 40, 8))
