"""The port's op counter (``repro_torch.launch.op_analysis``) against the
reference's HLO analyzer (``repro.launch.hlo_analysis``) on the same
programs (the five cases of ``tests/test_hlo_analysis.py``, the
reference's side compiled by jax on the CPU), its kernel formulas'
route independence (``cpu`` and ``meta`` count the same, no inner op of
a wrapper is counted), its formulas against the hand counts the chip
smoke test used for its bounds, and the GEMM FLOPs of the dense and
Mamba-2 smoke forwards against 2 x tokens x their matmul weights."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_analysis as H  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.conv3d import ops as conv_ops  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.stmul import ops as stmul_ops  # noqa: E402
from repro_torch.launch import op_analysis as oa  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import model_api  # noqa: E402

GEMMS = ("mm", "bmm", "addmm", "baddbmm")


def _reference(fn, *sds) -> H.Analysis:
    return H.analyze_hlo(jax.jit(fn).lower(*sds).compile().as_text())


def _count(fn, *args):
    """``fn(*args)`` under a fresh counter: (its result, the analysis)."""
    with oa.OpCounter() as counter:
        out = fn(*args)
    return out, counter.analysis


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- the reference's five cases ----------------------------------------------


def test_dot_flops_exact_as_the_reference():
    want = _reference(
        lambda x, y: x @ y,
        jax.ShapeDtypeStruct((64, 128), jnp.float32), jax.ShapeDtypeStruct((128, 32), jnp.float32),
    ).op_flops["dot"]
    _, a = _count(torch.mm, _meta(64, 128), _meta(128, 32))
    assert a.op_flops == {"mm": want} and want == 2 * 64 * 32 * 128
    assert a.flops_by_class == {oa.F32_GEMM: want}


def _scan_ref(w, x):
    def body(c, wl):
        return jnp.tanh(c @ wl), None

    return jax.lax.scan(body, x, w)[0]


def _scan_port(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def test_loop_of_seven_counts_seven_times_as_the_reference():
    """The reference multiplies a scan body by its trip count; the port's
    Python loop runs (and counts) every iteration."""
    want = _reference(
        _scan_ref, jax.ShapeDtypeStruct((7, 32, 32), jnp.float32), jax.ShapeDtypeStruct((8, 32), jnp.float32)
    ).op_flops["dot"]
    _, a = _count(_scan_port, _meta(7, 32, 32), _meta(8, 32))
    assert a.op_flops["mm"] == want == 7 * 2 * 8 * 32 * 32
    assert a.op_counts["mm"] == 7 and a.op_flops["tanh"] == 7 * 8 * 32


def test_fft_flops_equal_the_reference():
    want = _reference(jnp.fft.fft, jax.ShapeDtypeStruct((64,), jnp.complex64)).op_flops["fft"]
    _, a = _count(torch.fft.fft, _meta(64, dtype=torch.complex64))
    assert a.op_flops == {"_fft_c2c": want} and want == 5 * 64 * math.log2(64)
    assert a.op_bytes["_fft_c2c"] == 2 * 64 * 8


def test_dtype_byte_sizes_equal_the_reference():
    assert oa.nbytes(_meta(4, 8, dtype=torch.bfloat16)) == H._bytes_of("bf16[4,8]{1,0}") == 64
    pair = oa.nbytes(_meta(2, 2)) + oa.nbytes(_meta(dtype=torch.int32))
    assert pair == H._bytes_of("(f32[2,2], s32[])") == 20
    assert oa.nbytes(_meta(dtype=torch.bool)) == H._bytes_of("pred[]") == 1
    assert oa.nbytes(_meta(dtype=torch.complex64)) == H._bytes_of("c64[]") == 8
    # a broadcast dimension is read once
    assert oa.nbytes(_meta(1, 8).expand(4, 8)) == 32


def test_stacked_weight_slices_count_slice_bytes_as_the_reference():
    """A loop over the layers of a stacked (L, D, D) weight reads one
    slice an iteration, not the whole stack."""
    L, D = 10, 64
    full_per_iter = L * (L * D * D * 4)  # the overcount to avoid
    ref = _reference(_scan_ref, jax.ShapeDtypeStruct((L, D, D), jnp.float32), jax.ShapeDtypeStruct((4, D), jnp.float32))
    _, a = _count(_scan_port, _meta(L, D, D), _meta(4, D))
    assert ref.hbm_bytes < 0.5 * full_per_iter and a.hbm_bytes < 0.5 * full_per_iter
    assert a.op_bytes["mm"] == L * 4 * (4 * D + D * D + 4 * D)
    assert "select" not in a.op_flops  # views cost nothing


# -- kernels: route independence ------------------------------------------------


def _randn(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _cplx(rng, *shape):
    return torch.complex(_randn(rng, *shape), _randn(rng, *shape))


def _kernel_cases(rng):
    """(name, fn, inputs, the call's kernel_cost) at small shapes."""
    B, O, C, F = 3, 5, 2, 37
    x, g = _cplx(rng, B, C, F), _cplx(rng, O, C, F)
    pre, pim = _randn(rng, 12, C, F, dtype=torch.bfloat16), _randn(rng, 12, C, F, dtype=torch.bfloat16)
    offs = [0, 3, 3]
    vals, gidx = _randn(rng, 6, 50), torch.arange(50, dtype=torch.int32)
    xc, wc = _randn(rng, 2, 2, 9, 10, 6), _randn(rng, 3, 2, 3, 4, 2)
    Bb, L, H, G, P, N, Q = 2, 32, 4, 2, 8, 4, 16
    ssd_in = (_randn(rng, Bb, L, H, P), torch.rand(Bb, L, H), -torch.rand(H),
              _randn(rng, Bb, L, G, N), _randn(rng, Bb, L, G, N))
    cases = [
        ("spectral_mac", lambda x, g: stmul_ops.spectral_mac(x, g), (x, g),
         oa.kernel_cost("spectral_mac", B=B, O=O, C=C, F=F)),
        ("spectral_mac_grouped", lambda x, r, i: stmul_ops.spectral_mac_grouped(x, r, i, offs, 4), (x, pre, pim),
         oa.kernel_cost("spectral_mac_grouped", B=B, C=C, F=F, o_start=offs, n_out=4, itemsize=2)),
        ("topk_readout", lambda v, i: stmul_ops.topk_readout(v, i, 3), (vals, gidx),
         oa.kernel_cost("topk_readout", R=6, L=50, k=3)),
        ("ssd", lambda *a: ssd_ops.ssd(*a, chunk=Q), ssd_in,
         oa.kernel_cost("ssd", Bb=Bb, L=L, H=H, G=G, P=P, N=N, chunk=Q)),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(("conv3d", conv_ops.conv3d, (xc.to(dtype), wc.to(dtype)),
                      oa.kernel_cost("conv3d", x_shape=(2, 2, 9, 10, 6), w_shape=(3, 2, 3, 4, 2), dtype=dtype)))
        for causal in (True, False):
            qkv = (_randn(rng, 2, 20, 4, 8, dtype=dtype), _randn(rng, 2, 24, 2, 8, dtype=dtype),
                   _randn(rng, 2, 24, 2, 8, dtype=dtype))
            cases.append(("flash_fwd", lambda q, k, v, c=causal: flash_ops.flash_attention(q, k, v, c), qkv,
                          oa.kernel_cost("flash_fwd", B=2, Sq=20, Sk=24, H=4, G=2, D=8, causal=causal, dtype=dtype)))
    return cases


CASES = [(c[0], i) for i, c in enumerate(_kernel_cases(np.random.default_rng(0)))]


def _summary(a: oa.Analysis) -> tuple:
    return (a.flops, a.hbm_bytes, a.op_flops, a.op_bytes, a.op_counts, a.flops_by_class, a.peak_live_bytes)


@pytest.mark.parametrize("name,i", CASES, ids=[f"{n}-{i}" for n, i in CASES])
def test_kernel_counts_one_op_by_its_formula_on_cpu_and_meta(name, i):
    """A wrapper call is one op, its formula's FLOPs, bytes and class, on
    the CPU (its plain version runs, uncounted) and on ``meta`` (shapes
    alone) alike, and its output the same live bytes on both."""
    _, fn, inputs, cost = _kernel_cases(np.random.default_rng(0))[i]
    counts = {}
    for dev in ("cpu", "meta"):
        with torch.no_grad():
            out, a = _count(fn, *(t.to(dev) for t in inputs))
        assert {t.device.type for t in ([out] if isinstance(out, torch.Tensor) else out)} == {dev}
        counts[dev] = _summary(a)
        assert a.op_flops == {name: cost.flops} and a.op_bytes == {name: cost.bytes}
        assert a.op_counts == {name: 1} and a.flops_by_class == {cost.cls: cost.flops}
    assert counts["cpu"] == counts["meta"]


@pytest.mark.parametrize("name,i", [c for c in CASES if c[0] in ("ssd", "conv3d", "flash_fwd")],
                         ids=lambda v: str(v))
def test_kernel_backward_counts_the_same_on_cpu_and_meta(name, i):
    """The plain backward under autograd is counted op by op, under the
    kernel's bucket, the same on both routes."""
    _, fn, inputs, _ = _kernel_cases(np.random.default_rng(0))[i]
    counts = {}
    for dev in ("cpu", "meta"):
        leaves = [t.to(dev).requires_grad_(t.is_floating_point()) for t in inputs]
        with oa.OpCounter() as c:
            out = fn(*leaves)
            out = out[0] if isinstance(out, tuple) else out
            torch.autograd.grad(out.float().sum(), [t for t in leaves if t.requires_grad])
        counts[dev] = _summary(c.analysis)
        bucket = name.replace("_fwd", "") + "_bwd(plain)"
        assert c.analysis.op_counts[name] == 1 and c.analysis.op_counts[bucket] > 1
    assert counts["cpu"] == counts["meta"]


def test_counter_outside_a_step_changes_nothing():
    """Without a counter the wrappers run as before; the meta route gives
    shapes and dtypes only, and other devices still raise."""
    q = torch.empty((1, 4, 2, 8), dtype=torch.bfloat16, device="meta")
    out = flash_ops.flash_attention(q, q, q, True)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == torch.bfloat16
    assert oa.active_counter() is None
    x = torch.empty((2, 1, 5), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="no backward"):
        stmul_ops.spectral_mac(x.requires_grad_(), x)


@pytest.mark.parametrize("route", ["stmul", "conv3d", "ssd", "flash"])
def test_devices_other_than_cuda_cpu_and_meta_still_raise(route):
    from types import SimpleNamespace

    xpu = SimpleNamespace(device=torch.device("xpu"), requires_grad=False)
    call = {
        "stmul": lambda: stmul_ops._mac(xpu, xpu, 2),
        "conv3d": lambda: conv_ops._forward(xpu, xpu),
        "ssd": lambda: ssd_ops._forward(xpu, xpu, xpu, xpu, xpu, 16),
        "flash": lambda: flash_ops._forward(xpu, xpu, xpu, True, None),
    }[route]
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        call()


# -- kernel formulas against the chip smoke test's former hand counts -----------


def _hand_bound_ms(nbytes, flops, rate):
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _hand_ssd(Bb, L, H, G, P, N, Q):
    nbytes = 4 * (2 * Bb * L * H * P + Bb * L * H + H + 2 * Bb * L * G * N + Bb * H * P * N)
    return nbytes, Bb * (L // Q) * (G * Q * (Q + 1) * N + H * (Q * (Q + 1) * P + 4 * Q * N * P))


def _hand_attn(B, Sq, Sk, H, G, D, causal, itemsize):
    n = min(Sq, Sk)
    pairs = n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk if causal else Sq * Sk
    return itemsize * D * (2 * B * Sq * H + 2 * B * Sk * G), 4 * D * B * H * pairs


FLASH_SHAPES = [(4, 2048, 2048, 12, 2, 128, True), (2, 1000, 1000, 12, 2, 128, True),
                (4, 2048, 2048, 32, 32, 160, True), (4, 1500, 1500, 6, 6, 64, False),
                (4, 2048, 1500, 6, 6, 64, False), (2, 1000, 1000, 56, 8, 128, True),
                (4, 2304, 2304, 16, 8, 128, True), (1, 100, 40, 4, 2, 64, True)]
SSD_SHAPES = [(4, 2048, 32, 1, 64, 128, 128), (2, 1024, 32, 1, 64, 128, 128),
              (4, 2048, 80, 1, 64, 64, 128), (2, 48, 8, 1, 16, 16, 16)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_formula_equals_the_former_hand_count(shape):
    B, Sq, Sk, H, G, D, causal = shape
    cost = oa.kernel_cost("flash_fwd", B=B, Sq=Sq, Sk=Sk, H=H, G=G, D=D, causal=causal, dtype=torch.bfloat16)
    nbytes, flops = _hand_attn(*shape, 2)
    assert (cost.bytes, cost.flops, cost.cls) == (nbytes, flops, oa.BF16_TC)
    got, by = roofline.kernel_bound_s(cost)
    want, want_by = _hand_bound_ms(nbytes, flops, 989e12)
    assert by == want_by and got * 1e3 == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_formula_equals_the_former_hand_count(shape):
    Bb, L, H, G, P, N, Q = shape
    cost = oa.kernel_cost("ssd", Bb=Bb, L=L, H=H, G=G, P=P, N=N, chunk=Q)
    nbytes, flops = _hand_ssd(*shape)
    assert (cost.bytes, cost.flops, cost.cls) == (nbytes, flops, oa.TF32X3)
    got, by = roofline.kernel_bound_s(cost)
    want, want_by = _hand_bound_ms(nbytes, flops, 495e12 / 3)
    assert by == want_by and got * 1e3 == pytest.approx(want, rel=1e-9)
    assert roofline.kernel_bound_s(cost, roofline.PEAK_FLOPS_F32)[0] * 1e3 == pytest.approx(
        _hand_bound_ms(nbytes, flops, 67e12)[0], rel=1e-9)


def test_stmul_and_conv_formulas_equal_the_former_hand_counts():
    from repro_torch.kernels.conv3d import kernel as conv_kernel

    F = 90 * 120 * 37
    b1 = oa.kernel_cost("spectral_mac", B=8, O=9, C=1, F=F)
    assert (b1.bytes, b1.flops) == ((8 * F + 9 * F + 8 * 9 * F) * 8, 8 * 8 * 9 * F)
    offs = [37, 3, 55, 12, 0, 41, 29, 8, 50, 19, 33, 1, 46, 24, 5, 14]
    used = len({o + j for o in offs for j in range(9)})
    b2 = oa.kernel_cost("spectral_mac_grouped", B=16, C=1, F=F, o_start=offs, n_out=9, itemsize=2)
    assert (b2.bytes, b2.flops) == (16 * F * 8 + 2 * used * F * 2 + 16 * 9 * F * 8, 8 * 16 * 9 * F)
    L = 4 * 31 * 41 * 57
    b3 = oa.kernel_cost("topk_readout", R=36, L=L, k=3)
    assert (b3.bytes, b3.flops) == (36 * L * 4 + L * 4 + 36 * 3 * 8, 0)
    for xs, ws in (((16, 1, 60, 80, 16), (9, 1, 30, 40, 8)), ((1, 16, 14, 14, 8), (16, 16, 3, 3, 3))):
        for dtype, cls in ((torch.float32, oa.TF32X3), (torch.bfloat16, oa.BF16_TC)):
            b4 = oa.kernel_cost("conv3d", x_shape=xs, w_shape=ws, dtype=dtype)
            out = xs[0] * ws[0] * math.prod(x - w + 1 for x, w in zip(xs[2:], ws[2:]))
            assert b4.flops == conv_kernel.flops(xs, ws) and b4.cls == cls
            assert b4.bytes == (math.prod(xs) + math.prod(ws) + out) * dtype.itemsize


# -- GEMM FLOPs of whole forwards ------------------------------------------------


MATMUL_WEIGHTS = {"qwen2-1.5b": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
                  "mamba2-370m": ("in_proj", "out_proj")}


@pytest.mark.parametrize("arch", list(MATMUL_WEIGHTS))
def test_forward_gemm_flops_are_two_per_token_per_matmul_weight(arch):
    """Outside B5 and B6 a smoke forward's GEMMs are its projections and
    the (tied) head: 2 x tokens x their weights, exactly.  B5 / B6 count
    one op a layer."""
    cfg = configs.get_smoke_config(arch)
    model = model_api.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 32
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, a = _count(model, tokens)
    weights = sum(p.numel() for n, p in model.named_parameters() if n.split(".")[-1] in MATMUL_WEIGHTS[arch])
    weights += cfg.vocab * cfg.d_model  # the head
    assert sum(a.op_flops.get(k, 0.0) for k in GEMMS) == 2 * B * S * weights
    kernel = "flash_fwd" if arch.startswith("qwen2") else "ssd"
    assert a.op_counts[kernel] == cfg.n_layers
