"""The port's DeepSeek-V2 model (multi-head latent attention + DeepSeekMoE)
against the JAX reference (``repro.models.mla``) on the reference's
smoke config: one dense layer, then two MoE layers of 8 experts, top 2,
one shared expert; kv_lora 32, qk_nope 16, qk_rope 8, v 16.

The whole-model checks are ``test_torch_moe.py``'s (its docstring gives
the tolerances and the bf16 routing replay): forward logits and aux,
prefill and its latent cache key by key (``ckv_dense``, ``kr_dense``,
``ckv_moe``, ``kr_moe``, ``length``), two absorbed decode steps against
the reference's ``decode_step``, the routing of every MoE layer, and
greedy ``LMServer.generate``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_moe import (  # noqa: E402
    _probs,
    check_cache_overflow,
    check_config_mirrors_reference,
    check_entry_points_need_a_device,
    check_generate,
    check_no_drop_consistency,
    check_param_layout,
    check_whole_model,
    dispatch_matches_reference,
    make_pair,
    rel_l2,
)

from repro import configs as r_configs  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import mla as t_mla  # noqa: E402
from repro_torch.models import model_api  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module", params=["bf16", "f32"])
def pair(request):
    return make_pair(ARCH, request.param)


def test_forward_prefill_and_decode_match_reference(pair):
    check_whole_model(pair)


def test_generate_matches_reference_tokens():
    check_generate(make_pair(ARCH, "f32"))


def test_consistency_no_drop():
    check_no_drop_consistency(ARCH)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_dispatch_bitwise_at_published_routing(arch):
    """Dispatch and combine at the published configs' routing (64 experts
    top 6; 128 experts top 2) on a 256-token group, ties planted."""
    rcfg, tcfg = r_configs.get_config(arch), t_configs.get_config(arch)
    for ties in (False, True):
        d, _ = dispatch_matches_reference(rcfg, tcfg, _probs((1, 256, tcfg.n_experts), 5, ties))
        assert d.sum() <= 256 * tcfg.top_k


def test_latent_cache_layout(pair):
    cfg = pair.tcfg
    cache = pair.model.init_cache(2, 11)
    r_cache, _ = pair.rmod.init_cache(pair.rcfg, 2, 11)
    assert set(cache) == set(r_cache)
    for key in ("ckv_dense", "kr_dense", "ckv_moe", "kr_moe"):
        assert tuple(cache[key].shape) == r_cache[key].shape and not cache[key].any(), key
        assert cache[key].dtype == cfg.compute_dtype
    assert cache["ckv_moe"].shape == (cfg.n_layers - cfg.first_k_dense, 2, 11, cfg.kv_lora)
    no_dense = t_mla.MLA(dataclasses.replace(cfg, first_k_dense=0), "cpu").init_cache(2, 11)
    assert set(no_dense) == {"ckv_moe", "kr_moe", "length"}


def test_absorbed_decode_equals_full_attention():
    """The absorbed latent decode attends as the decompressed full path
    does: one layer's decode of position 5 against ``full`` on 6 tokens."""
    pair = make_pair(ARCH, "f32")
    blk = pair.model.layers[0]
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 6, pair.tcfg.d_model).astype(np.float32))
    pos = torch.arange(6)[None].expand(2, 6)
    with torch.inference_mode():
        full, (c_kv, k_rope) = blk.full(x, pos)
        ckv = torch.zeros(2, 8, pair.tcfg.kv_lora)
        kr = torch.zeros(2, 8, pair.tcfg.qk_rope)
        ckv[:, :5], kr[:, :5] = c_kv[:, :5], k_rope[:, :5]
        step = blk.decode(x[:, 5:6], 5, ckv, kr)
    assert rel_l2(step.numpy(), full[:, 5:6].numpy()) <= 1e-5
    assert torch.allclose(ckv[:, 5], c_kv[:, 5], atol=1e-6)


def test_cache_overflow_raises(pair):
    check_cache_overflow(pair)


@pytest.mark.parametrize(
    "what,match",
    [("dense_layers.w_gate", r"dense_layers.w_gate\[0\]"), ("dense_layers", r"missing \['dense_layers'\]"),
     ("layers.kv_ln", r"layers hold.*missing \['kv_ln'\]"), ("layers.moe.ws_up", r"layers.moe.ws_up\[1\]"),
     ("layers.moe.router", r"layers.moe.router\[0\].*float32"), ("embed", "embed: got")],
)
def test_params_from_numpy_names_the_wrong_field(pair, what, match):
    tree = jax.tree.map(np.asarray, pair.params)
    tree = {**tree, "layers": {**tree["layers"], "moe": dict(tree["layers"]["moe"])},
            "dense_layers": dict(tree["dense_layers"])}
    if what == "dense_layers.w_gate":
        tree["dense_layers"]["w_gate"] = tree["dense_layers"]["w_gate"][..., :-1]
    elif what == "dense_layers":
        del tree["dense_layers"]
    elif what == "layers.kv_ln":
        del tree["layers"]["kv_ln"]
    elif what == "layers.moe.ws_up":
        tree["layers"]["moe"]["ws_up"] = tree["layers"]["moe"]["ws_up"].astype(np.float16)
    elif what == "layers.moe.router":
        tree["layers"]["moe"]["router"] = tree["layers"]["moe"]["router"].astype(jnp.bfloat16)
    elif what == "embed":
        tree["embed"] = tree["embed"][:-1]
    if what == "layers.moe.ws_up":
        match = r"layers.moe.ws_up\[0\]"
    with pytest.raises(ValueError, match=match):
        interop.mla_params_from_numpy(tree, pair.tcfg, device="cpu")


def test_entry_points_need_a_device(pair):
    check_entry_points_need_a_device(pair, t_mla.init_params)
    assert model_api.get_model(pair.tcfg) is t_mla


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_mirrors_reference(get):
    check_config_mirrors_reference(ARCH, get)


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_param_layout_matches_reference_tree(get):
    check_param_layout(ARCH, get)


def test_published_config():
    t = t_configs.get_config(ARCH)
    assert t.num_params() == 15_706_470_400
    assert t_configs.get_smoke_config(ARCH).num_params() == 252_864
    assert (t.n_layers, t.first_k_dense, t.d_model, t.n_heads, t.d_ff) == (27, 1, 2048, 16, 10944)
    assert (t.kv_lora, t.qk_nope, t.qk_rope, t.v_dim, t.qk_dim) == (512, 128, 64, 128, 192)
    assert (t.n_experts, t.top_k, t.moe_d_ff, t.n_shared_experts) == (64, 6, 1408, 2)
    assert t.router_group == 2048 and t.vocab == 102400 and not t.tie_embeddings
    assert t.param_dtype == t.compute_dtype == torch.bfloat16
    assert model_api.model_flops_per_token(t) == 6.0 * t.active_params()


def test_init_params_draws_norms_and_experts():
    cfg = t_configs.get_smoke_config(ARCH)
    m = t_mla.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for blk in (*m.dense_layers, *m.layers):
        for name in t_mla.NORMS:
            assert torch.equal(getattr(blk, name), torch.ones_like(getattr(blk, name)))
    assert [blk.is_moe for blk in (*m.dense_layers, *m.layers)] == [False, True, True]
    assert not hasattr(m.dense_layers[0], "moe") and not hasattr(m.layers[0], "w_gate")
    assert m.layers[1].moe.router.dtype == torch.float32
