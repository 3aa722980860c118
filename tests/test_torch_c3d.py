"""C3D on the port (``models/c3d.py``) against its plain reference
(``models/c3d_ref.py``: plain torch, float32, TF32 off, no kernel of the
port) at the smoke size on the CPU, served through
``C3DClassifierServer``; the conv3d op's C3D options (border, bias,
ReLU, channels-last), forward only; and what the CPU can check of
B4's implicit-GEMM route (``csrc/conv3d_igemm.cu``): its launch plan at
C3D's eight layer shapes covers every output once within the card's
limits, and its 3xTF32 arithmetic with float32 flushes keeps float32's
accuracy under the tensor cores' truncating accumulation.  There is no
JAX counterpart: C3D is the port's own configuration.  The kernel itself
is held to the plain version on the card by ``test_torch_c3d_card.py``.

Tolerances: the port and the reference both run float32 convolutions on
the CPU (oneDNN), in different layouts and summation orders: logits
agree to 1e-5 of the largest one (the two differ by ~1e-7 of it).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from repro_torch import configs, tracing  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv3d import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.conv3d import ops as t_ops  # noqa: E402
from repro_torch.kernels.conv3d import ref as t_ref  # noqa: E402
from repro_torch.launch.serve import C3DClassifierServer  # noqa: E402
from repro_torch.models import c3d, c3d_ref  # noqa: E402

CONV_RTOL = 1e-5  # relative L2 that B4 is held to in float32
# C3D's convolutions (conv1a ... conv5b): input channels, filters, side, frames
LAYERS = [(3, 64, 112, 16), (64, 128, 56, 16), (128, 256, 28, 8), (256, 256, 28, 8),
          (256, 512, 14, 4), (512, 512, 14, 4), (512, 512, 7, 2), (512, 512, 7, 2)]


def _smoke_model(seed=0):
    cfg = configs.get_smoke_config("c3d-sports1m")
    gen = torch.Generator().manual_seed(seed)
    params = c3d.init_params(cfg, gen, device="cpu", bias_std=0.1)
    clips = torch.rand(3, cfg.in_channels, cfg.height, cfg.width, cfg.frames, generator=gen)
    return cfg, params, clips


def test_the_published_configuration():
    cfg = configs.get_config("c3d-sports1m")
    assert [(n, c, o) for n, c, o in cfg.convs()] == [
        ("conv1a", 3, 64), ("conv2a", 64, 128), ("conv3a", 128, 256), ("conv3b", 256, 256),
        ("conv4a", 256, 512), ("conv4b", 512, 512), ("conv5a", 512, 512), ("conv5b", 512, 512)]
    assert cfg.pooled_shape() == (4, 4, 1) and cfg.features == 8192
    assert cfg.fcs() == [("fc6", 8192, 4096), ("fc7", 4096, 4096), ("fc8", 4096, 487)]
    n = sum(math.prod(s) for s in c3d.param_shapes(cfg).values())
    assert n == 79_991_015  # 80.0 M, 320 MB in float32
    assert "c3d_sports1m" in configs.PORTED and "c3d_sports1m" in configs.VIDEO


def test_forward_matches_the_plain_reference():
    cfg, params, clips = _smoke_model()
    got = c3d.forward(params, clips)
    want = c3d_ref.forward(params.state_dict(), clips, cfg)
    assert got.shape == (3, cfg.num_classes) and got.dtype == torch.float32
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) <= 1e-5


def test_the_server_classifies_and_marks_its_layers():
    cfg, params, clips = _smoke_model(1)
    want = c3d_ref.forward(params.state_dict(), clips, cfg).argmax(-1).numpy()
    server = C3DClassifierServer(params, device="cpu")
    tracing.start()
    try:
        got = server.classify(clips.numpy())
    finally:
        spans = tracing.stop()
    np.testing.assert_array_equal(got, want)
    names = [s[0] for s in spans]
    layers = [f"c3d.{n}" for n, _, _ in cfg.convs()] + [f"c3d.pool{i}" for i in range(1, 6)]
    for name in ["classify.upload", "classify.conv", "classify.head", "classify.readback", *layers]:
        assert names.count(name) == 1, name
    conv = next(s for s in spans if s[0] == "classify.conv")
    assert all(s[2] == conv[1] for s in spans if s[0].startswith("c3d."))  # inside the trunk


@pytest.mark.parametrize("shape,window", [
    ((2, 8, 8, 4, 3), (2, 2, 1)),  # pool1: rows and columns only
    ((2, 8, 8, 4, 3), (2, 2, 2)),
    ((2, 7, 7, 2, 5), (2, 2, 2)),  # pool5: 7x7x2 -> 4x4x1, rounding up
    ((1, 5, 3, 3, 2), (2, 2, 2)),
])
def test_channels_last_pool_matches_max_pool3d_rounding_up(shape, window):
    x = torch.randn(shape)
    got = c3d.max_pool_cl(x, window)
    ph, pw, pt = window
    want = F.max_pool3d(x.permute(0, 4, 3, 1, 2), (pt, ph, pw), stride=(pt, ph, pw), ceil_mode=True)
    assert torch.equal(got, want.permute(0, 3, 4, 2, 1))


@pytest.mark.parametrize("channels_last", [False, True])
def test_conv3d_border_bias_relu_match_their_plain_composition(channels_last):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 6, 5, 4, generator=gen)
    w = torch.randn(64, 3, 3, 3, 3, generator=gen)
    b = torch.randn(64, generator=gen)
    want = F.relu(F.conv3d(x, w, b, padding=1))
    xin = x.permute(0, 2, 3, 4, 1) if channels_last else x
    got = t_ops.conv3d(xin, w, pad=1, bias=b, relu=True, channels_last=channels_last)
    if channels_last:
        assert got.is_contiguous() and got.shape == (2, 6, 5, 4, 64)
        got = got.permute(0, 4, 1, 2, 3)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    meta = t_ops.conv3d(xin.to("meta"), w.to("meta"), pad=1, channels_last=channels_last)
    assert meta.shape == ((2, 6, 5, 4, 64) if channels_last else (2, 64, 6, 5, 4))


def test_conv3d_options_are_forward_only():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 5, 3, 32, generator=gen, requires_grad=True)
    w = torch.randn(64, 32, 3, 3, 3, generator=gen, requires_grad=True)
    y = t_ops.conv3d(x, w, pad=1, relu=True, channels_last=True)
    with pytest.raises(NotImplementedError, match="valid correlation only"):
        y.sum().backward()


def test_route_counters_count_by_route_and_sum():
    t_kernel.reset_launches()
    assert t_kernel.conv3d_cuda.launches == 0
    assert t_kernel.conv3d_cuda.route_launches == dict.fromkeys(t_kernel.ROUTES, 0)
    _build.count(t_kernel.conv3d_cuda, "igemm")
    _build.count(t_kernel.conv3d_cuda, "fma")
    _build.count(t_kernel.conv3d_cuda, "igemm")
    assert t_kernel.conv3d_cuda.route_launches == {"wgmma": 0, "igemm": 2, "fma": 1}
    assert t_kernel.conv3d_cuda.launches == 3
    t_kernel.reset_launches()
    assert t_kernel.conv3d_cuda.launches == 0 and not any(t_kernel.conv3d_cuda.route_launches.values())


# -- the implicit-GEMM route's plan --------------------------------------------


def _igemm_coverage(x_shape, w_shape, pad, p):
    """How often the implicit-GEMM kernel stores each (output position,
    block of output channels), as csrc/conv3d_igemm.cu maps blocks (O
    fastest) and a block's 128 rows onto its box; and that a block's
    threads store each (row, channel) once (rows r0 and r0 + 8, channels
    8j + 2tq + e of its accumulator)."""
    B, C, H, W, T = x_shape
    O, _, kh, kw, kt = w_shape
    OH, OW, OT = H + 2 * pad - kh + 1, W + 2 * pad - kw + 1, T + 2 * pad - kt + 1
    nh, nw, nt, nn = -(-OH // p.bh), -(-OW // p.bw), -(-OT // p.bt), O // p.bn
    assert B * nh * nw * nt * nn == p.blocks
    seen = np.zeros((t_kernel.IG_BM, p.bn), np.int64)
    for tid in range(256):
        wg, warp, lane = tid // 128, (tid // 32) % 4, tid % 32
        for h in range(2):
            r = wg * 64 + warp * 16 + lane // 4 + 8 * h
            for j in range(p.bn // 8):
                for e in range(2):
                    seen[r, 8 * j + 2 * (lane % 4) + e] += 1
    assert (seen == 1).all()
    bid, r = np.meshgrid(np.arange(p.blocks), np.arange(t_kernel.IG_BM), indexing="ij")
    nb, rest = bid % nn, bid // nn
    tb, rest = rest % nt, rest // nt
    wb, rest = rest % nw, rest // nw
    hb, b = rest % nh, rest // nh
    tt, ww, hh = r % p.bt, (r // p.bt) % p.bw, r // (p.bt * p.bw)
    i, j, k = hb * p.bh + hh, wb * p.bw + ww, tb * p.bt + tt
    live = (hh < p.bh) & (i < OH) & (j < OW) & (k < OT)
    count = np.zeros((B, OH, OW, OT, nn), np.int64)
    np.add.at(count, (b[live], i[live], j[live], k[live], nb[live]), 1)
    return count


@pytest.mark.parametrize("c,o,side,frames", LAYERS + [(3, 128, 20, 8)])  # and a gather at bn 128
def test_igemm_plan_covers_every_output_once_within_limits(c, o, side, frames):
    x_shape, w_shape = (2, c, side, side, frames), (o, c, 3, 3, 3)
    p = t_kernel.igemm_plan(x_shape, w_shape, pad=1)
    assert p.fold == (c == 3) and p.bn == (128 if o % 128 == 0 else 64)
    assert 1 <= p.bh * p.bw * p.bt <= t_kernel.IG_BM and p.stages >= 2
    assert p.stages == (3 if p.fold and p.bn == 64 else t_kernel.IG_RING // (128 * (128 + 2 * p.bn)))
    assert p.threads == t_kernel.IG_THREADS and p.smem <= t_kernel.MAX_SMEM
    assert (_igemm_coverage(x_shape, w_shape, 1, p) == 1).all()
    K = 3 * 32 if p.fold else 27 * c
    assert p.workspace_floats == 2 * o * K + (2 * side * side * frames * 32 if p.fold else 0)


def test_igemm_plan_fills_the_card_at_the_cell_batch():
    """At 128 clips every layer's grid covers the card, and the boxes of
    the large layers waste no row: conv1a and conv2a in runs of 16
    frames x 8 columns, conv3a/b in 4 x 4 x 8 boxes."""
    blocks = [t_kernel.igemm_plan((128, c, s, s, t), (o, c, 3, 3, 3), 1) for c, o, s, t in LAYERS]
    assert min(p.blocks for p in blocks) >= t_kernel.SMS
    assert [(p.bh, p.bw, p.bt) for p in blocks[:4]] == [(1, 8, 16), (1, 8, 16), (4, 4, 8), (4, 4, 8)]


def test_igemm_plan_refuses_what_route_sends_elsewhere():
    with pytest.raises(ValueError, match="implicit-GEMM"):
        t_kernel.igemm_plan((1, 16, 14, 14, 8), (16, 16, 3, 3, 3))  # C 16, O 16: FMA
    with pytest.raises(ValueError, match="implicit-GEMM"):
        t_kernel.igemm_plan((1, 64, 14, 14, 8), (64, 64, 3, 3, 5))


# -- the implicit-GEMM route's arithmetic --------------------------------------


def _rz32(a):
    """float64 -> float32 rounded toward zero, as the tensor cores' float32
    accumulation rounds."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _igemm_sum(x, w, flush_steps):
    """Sums as the implicit-GEMM kernel forms them: per k8 step x_hi·w_hi,
    x_hi·w_lo and x_lo·w_hi into one accumulator, each add rounded toward
    zero; every ``flush_steps`` k8 steps (0: never) the accumulator is
    added to a float32 sum and restarts from zero."""
    xh, xl = (t.numpy().astype(np.float64) for t in t_ref.tf32_split(torch.from_numpy(x)))
    wh, wl = (t.numpy().astype(np.float64) for t in t_ref.tf32_split(torch.from_numpy(w)))
    total = np.zeros(x.shape[0], np.float32)
    acc = np.zeros_like(total)
    for s in range(x.shape[1] // 8):
        k = slice(8 * s, 8 * s + 8)
        for a, b in ((xh, wh), (xh, wl), (xl, wh)):
            acc = _rz32(acc + a[:, k] @ b[k])
        if flush_steps and (s + 1) % flush_steps == 0:
            total, acc = total + acc, np.zeros_like(acc)
    return total + acc


def test_igemm_flushes_keep_float32_accuracy_under_truncating_accumulation():
    """conv5b's K = 512 x 27 = 13,824 over post-ReLU inputs: without
    flushes the truncating accumulation drifts past CONV_RTOL; flushing
    every 8 stages of 4 k8 steps (the kernel's kFlush) keeps it well
    inside, where TF32 alone is off by ~1e-4."""
    rng = np.random.RandomState(5)
    x = rng.rand(128, 13824).astype(np.float32)
    w = (rng.randn(13824) * (2 / 13824) ** 0.5).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)

    def rel(v):
        return float(np.linalg.norm(v - exact) / np.linalg.norm(exact))

    assert rel(_igemm_sum(x, w, 0)) > CONV_RTOL
    assert rel(_igemm_sum(x, w, 32)) <= CONV_RTOL / 3
    xh, _ = t_ref.tf32_split(torch.from_numpy(x))
    wh, _ = t_ref.tf32_split(torch.from_numpy(w))
    assert rel(xh.double().numpy() @ wh.double().numpy()) > CONV_RTOL
