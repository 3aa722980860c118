"""The port's optimizer substrate (``repro_torch.optim``) against the JAX
reference's (``repro.optim``): every test of ``tests/test_optim.py`` on
the port, and each function held against the reference on identical
numpy inputs.

Tolerances: AdamW's parameters and moments within 1e-6 relative L2 per
leaf over 5 steps (float32 elementwise arithmetic in the same order);
bfloat16 moments within 1e-2 (one bfloat16 step is 2^-8); the cosine
schedule within 1e-6 absolute at every step; the compressor's int8
codes equal and its residual within 1e-6 of max |g|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from _hypo import given, settings, st  # noqa: E402

from repro import optim as r_optim  # noqa: E402
from repro.optim import compression as r_comp  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_gradients,
    compression_init,
    cosine_schedule,
    global_norm,
    linear_warmup,
)
from repro_torch.optim import compression as t_comp  # noqa: E402

RTOL = 1e-6
BF16_RTOL = 1e-2


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _quadratic_problem(dim=16, seed=0):
    rng = np.random.RandomState(seed)
    target = torch.from_numpy(rng.randn(dim).astype(np.float32))

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    return loss, {"w": torch.zeros(dim, requires_grad=True)}, target


def _grad(loss, params):
    (g,) = torch.autograd.grad(loss(params), [params["w"]])
    return {"w": g}


# -- tests/test_optim.py on the port -------------------------------------------


def test_adamw_converges_quadratic():
    loss, params, _ = _quadratic_problem()
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, clip_norm=1e9)
    state = adamw_init(cfg, params)
    for _ in range(300):
        params, state, _ = adamw_update(cfg, params, _grad(loss, params), state)
    assert loss(params).item() < 1e-2
    assert int(state["step"]) == 300


def test_clip_norm_applied():
    cfg = AdamWConfig(clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(cfg, params)
    _, _, metrics = adamw_update(cfg, params, {"w": torch.full((4,), 100.0)}, state)
    assert float(metrics["grad_norm"]) > 1.0
    assert float(metrics["clip_scale"]) < 1.0


def test_bf16_state_dtype():
    cfg = AdamWConfig(state_dtype=torch.bfloat16)
    params = {"w": torch.zeros(4)}
    state = adamw_init(cfg, params)
    assert state["m"]["w"].dtype == torch.bfloat16
    p2, s2, _ = adamw_update(cfg, params, {"w": torch.ones(4)}, state)
    assert s2["v"]["w"].dtype == torch.bfloat16
    assert bool(torch.all(torch.isfinite(p2["w"])))


def test_cosine_schedule_shape():
    assert float(cosine_schedule(0, 100, warmup_steps=10)) < 0.2
    assert abs(float(cosine_schedule(10, 100, warmup_steps=10)) - 1.0) < 0.05
    assert float(cosine_schedule(99, 100, warmup_steps=10)) < 0.2


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 1000), block=st.sampled_from([32, 256]))
def test_quantizer_bounded_error(seed, block):
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(300).astype(np.float32) * 10)
    q = t_comp._quantize_leaf(g, block)
    step = torch.max(torch.abs(g)) / 127.0
    assert float(torch.max(torch.abs(q - g))) <= float(step) + 1e-5


def test_error_feedback_accumulates_residual():
    g = {"w": torch.tensor([1e-4, 5.0, -3.0, 1e-5])}
    err = compression_init(g)
    comp, err = compress_gradients(g, err)
    np.testing.assert_allclose((comp["w"] + err["w"]).numpy(), g["w"].numpy(), atol=1e-6)


def test_compression_convergence_parity():
    """int8 + error feedback must not break optimization: the final loss
    within 2× of the uncompressed run on the quadratic."""
    loss, _, _ = _quadratic_problem(seed=3)
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, clip_norm=1e9)

    def run(compressed: bool) -> float:
        p = {"w": torch.zeros(16, requires_grad=True)}
        state = adamw_init(cfg, p)
        err = compression_init(p)
        for _ in range(300):
            g = _grad(loss, p)
            if compressed:
                g, err = compress_gradients(g, err)
            p, state, _ = adamw_update(cfg, p, g, state)
        return loss(p).item()

    plain, comp = run(False), run(True)
    assert comp < max(2 * plain, 5e-2), (plain, comp)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6


# -- parity with the reference on identical inputs -----------------------------


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    shapes = {"conv_w": (4, 1, 7, 9, 4), "conv_b": (4,), "fc1_w": (96, 32), "fc2_b": (4,)}
    return {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}


def _run_both(cfg_kw, grad_scale, r_state_dtype=jnp.float32, t_state_dtype=torch.float32,
              steps=5, lr_scales=None):
    """``steps`` AdamW updates in both packages from the same parameters
    and gradients; returns the reference's (params, state, metrics) and
    the port's."""
    p0 = _tree(0)
    grads = [_tree(10 + i, grad_scale) for i in range(steps)]
    scales = lr_scales or [1.0] * steps
    r_cfg = r_optim.AdamWConfig(state_dtype=r_state_dtype, **cfg_kw)
    t_cfg = AdamWConfig(state_dtype=t_state_dtype, **cfg_kw)
    r_p = {k: jnp.asarray(v) for k, v in p0.items()}
    r_s = r_optim.adamw_init(r_cfg, r_p)
    t_p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    t_s = adamw_init(t_cfg, t_p)
    for g, sc in zip(grads, scales):
        r_p, r_s, r_m = r_optim.adamw_update(
            r_cfg, r_p, {k: jnp.asarray(v) for k, v in g.items()}, r_s, lr_scale=sc)
        t_p, t_s, t_m = adamw_update(
            t_cfg, t_p, {k: torch.from_numpy(v) for k, v in g.items()}, t_s, lr_scale=sc)
    return (r_p, r_s, r_m), (t_p, t_s, t_m)


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_update_matches_reference(clip):
    grad_scale = 10.0 if clip == "active" else 1e-3
    kw = dict(lr=3e-3, weight_decay=0.01)
    (r_p, r_s, r_m), (t_p, t_s, t_m) = _run_both(kw, grad_scale, lr_scales=[0.1, 0.4, 1.0, 0.7, 0.05])
    assert (float(r_m["clip_scale"]) < 1.0) == (clip == "active")
    assert abs(float(t_m["clip_scale"]) - float(r_m["clip_scale"])) <= RTOL * float(r_m["clip_scale"])
    assert int(t_s["step"]) == int(r_s["step"]) == 5
    for k in r_p:
        assert _rel_l2(t_p[k].numpy(), r_p[k]) <= RTOL, k
        assert _rel_l2(t_s["m"][k].numpy(), r_s["m"][k]) <= RTOL, k
        assert _rel_l2(t_s["v"][k].numpy(), r_s["v"][k]) <= RTOL, k


def test_bf16_state_matches_reference():
    (r_p, r_s, _), (t_p, t_s, _) = _run_both(
        dict(lr=1e-2), 1.0, r_state_dtype=jnp.bfloat16, t_state_dtype=torch.bfloat16)
    for k in r_p:
        assert t_s["m"][k].dtype == torch.bfloat16 and r_s["m"][k].dtype == jnp.bfloat16
        for got, want in ((t_p[k], r_p[k]), (t_s["m"][k], r_s["m"][k]), (t_s["v"][k], r_s["v"][k])):
            assert _rel_l2(got.float().numpy(), np.asarray(want, np.float32)) <= BF16_RTOL, k


def test_cosine_schedule_matches_reference_at_every_step():
    total, warmup = 270, 30
    steps = torch.arange(total, dtype=torch.int32)
    got = cosine_schedule(steps, total, warmup, 0.05).numpy()
    want = np.asarray(r_optim.cosine_schedule(jnp.arange(total, dtype=jnp.int32), total, warmup, 0.05))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(float(cosine_schedule(0, total, warmup, 0.05)) - 1 / 30) <= 1e-6  # step 0: 1/30
    for s in (0, 7, 29, 30, 269, torch.tensor(12, dtype=torch.int32)):
        r = float(r_optim.linear_warmup(jnp.asarray(int(s), jnp.int32), warmup))
        assert abs(float(linear_warmup(s, warmup)) - r) <= 1e-6
        assert abs(float(cosine_schedule(s, total, warmup, 0.05))
                   - float(r_optim.cosine_schedule(int(s), total, warmup, 0.05))) <= 1e-6


@pytest.mark.parametrize("block", [32, 256])
def test_compress_gradients_matches_reference(block):
    g = {k: v * 10 for k, v in _tree(5).items()}
    e = _tree(6, 0.01)
    t_comp_g, t_err = compress_gradients(
        {k: torch.from_numpy(v) for k, v in g.items()}, {k: torch.from_numpy(v) for k, v in e.items()},
        block)
    r_comp_g, r_err = r_comp.compress_gradients(
        {k: jnp.asarray(v) for k, v in g.items()}, {k: jnp.asarray(v) for k, v in e.items()}, block)
    for k in g:
        corrected = torch.from_numpy(g[k] + e[k])
        codes, scale = t_comp._quantize_codes(corrected, block)
        # the reference returns codes × scale: its codes, read back by the scale
        r_flat = np.asarray(r_comp_g[k]).reshape(-1)
        r_flat = np.pad(r_flat, (0, codes.numel() - r_flat.size)).reshape(codes.shape)
        assert np.array_equal(codes.numpy(), np.rint(r_flat / scale.numpy()))
        assert float(codes.abs().max()) <= 127
        bound = 1e-6 * float(np.max(np.abs(g[k])))
        assert float(np.max(np.abs(t_err[k].numpy() - np.asarray(r_err[k])))) <= bound, k
        assert np.allclose(t_comp_g[k].numpy(), np.asarray(r_comp_g[k]), rtol=0, atol=bound), k


def test_quantize_leaf_matches_reference():
    rng = np.random.RandomState(1)
    for n, block in ((300, 32), (1000, 256), (5, 256)):
        g = rng.randn(n).astype(np.float32) * 10
        got = t_comp._quantize_leaf(torch.from_numpy(g), block).numpy()
        want = np.asarray(r_comp._quantize_leaf(jnp.asarray(g), block))
        assert np.array_equal(got, want)


def test_global_norm_matches_reference():
    tree = _tree(7)
    got = float(global_norm({k: torch.from_numpy(v) for k, v in tree.items()}))
    want = float(r_optim.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    assert abs(got - want) <= RTOL * want
