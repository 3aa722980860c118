"""The port's Whisper encoder–decoder (``repro_torch.models.whisper``), its
LayerNorm and sinusoidal table, attention with Sq != Sk and no mask, and
``LMServer`` on the audio family, against the JAX reference on the
reference's smoke config.

The reference's ``init_params`` tree is carried into the port with
``interop.whisper_params_from_numpy``; the reference runs its attention
blockwise, the port through its kernel route (the flash kernel's plain
version on the CPU, the same arithmetic).  Tolerances: 1e-4 absolute on
float32 logits and caches (both packages compute the same float32 ops
in other orders), 2e-4 for the port's own prefill + decode against its
teacher-forced forward (the reference test's own bound).  In bf16 the
port is held as ROADMAP C.15 holds Zamba-2: relative L2 <= 5e-2 against
the reference's bf16 (the two frameworks round bf16 at different
places), and no farther from the reference's float32-compute run than
1.25x the reference's own bf16 run is, pooled over the forward logits,
over the prefill and decode logits, and over each cache tensor.  Greedy
tokens must be equal, but for a row whose first differing token the
reference itself scores within its tie margin of its top token (1e-5 in
float32, its own bf16 rounding error in bf16); the test reports each
such row and stops comparing it.
"""

import dataclasses
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests elsewhere must not starve
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro.models import common as r_common  # noqa: E402
from repro.models import whisper as r_whisper  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.interop import whisper_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash import kernel as flash_kernel  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import model_api  # noqa: E402
from repro_torch.models import whisper as t_whisper  # noqa: E402

ARCH = "whisper-tiny"
ATOL = 1e-4
SELF_TOL = 2e-4
BF16_ACCURACY = 1.25  # the port's bf16 error over the reference's own
# (reference overrides, port overrides, float32 tie margin)
DTYPES = {
    "f32": ({}, {}, 1e-5),
    "bf16": (
        {"param_dtype": jnp.bfloat16, "compute_dtype": jnp.bfloat16},
        {"param_dtype": torch.bfloat16, "compute_dtype": torch.bfloat16},
        None,
    ),
}
BF16_RTOL = 5e-2
CACHE_KEYS = ("self_k", "self_v", "cross_k", "cross_v")


def f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def rel_l2(got, want) -> float:
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def close(got, want, bf16, atol=ATOL):
    if bf16:
        assert rel_l2(got, want) <= BF16_RTOL
    else:
        np.testing.assert_allclose(f32(got), f32(want), atol=atol, rtol=0)


class Accuracy:
    """In bf16, the port's and the reference's distances from the
    reference's float32-compute run, pooled by name; ``check`` holds
    each pool to ``BF16_ACCURACY``."""

    def __init__(self):
        self.sq = {}

    def add(self, name, got, want, exact):
        e = f32(exact).astype(np.float64)
        port, ref = self.sq.get(name, (0.0, 0.0))
        self.sq[name] = (port + float(np.sum((f32(got) - e) ** 2)),
                         ref + float(np.sum((f32(want) - e) ** 2)))

    def check(self):
        for name, (port, ref) in self.sq.items():
            assert np.sqrt(port) <= BF16_ACCURACY * np.sqrt(ref), (name, np.sqrt(port / ref))


def make_batch(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    return {
        "tokens": rng.randint(0, cfg.vocab, (B, S)),
        "frames": rng.randn(B, cfg.n_frames, cfg.d_model).astype(np.float32),
    }


def J(batch):
    return {"tokens": jnp.asarray(batch["tokens"], jnp.int32), "frames": jnp.asarray(batch["frames"])}


def T(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request):
    r_over, t_over, _ = DTYPES[request.param]
    rcfg = r_configs.get_smoke_config(ARCH, **r_over)
    tcfg = t_configs.get_smoke_config(ARCH, **t_over)
    params, _ = r_whisper.init_params(rcfg, jax.random.PRNGKey(0))
    model = whisper_params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return rcfg, params, tcfg, model, make_batch(tcfg, 2, 11, 0)


# --------------------------------------------------------------- configs


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_mirrors_reference(get):
    r = getattr(r_configs, get)(ARCH)
    t = getattr(t_configs, get)(ARCH)
    r_fields = {f.name for f in dataclasses.fields(r)}
    for f in dataclasses.fields(t):
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(getattr(t, f.name)).removeprefix("torch.") == jnp.dtype(getattr(r, f.name)).name
        elif f.name != "attn_impl":  # the port's own route
            assert f.name in r_fields and getattr(t, f.name) == getattr(r, f.name), f.name
    assert t.hd == r.hd and t.num_params() == r.num_params()
    assert t.family == "audio" and t.attn_impl == "kernel"
    assert model_api.get_model(t) is t_whisper


def _tree_layout(tree) -> dict:
    return {jax.tree_util.keystr(path): (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _module_layout(model) -> dict:
    """The port's parameters in the reference tree's layout: the two
    layer stacks' fields with the layer count in front."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        dt = str(p.dtype).removeprefix("torch.")
        if parts[0] in ("enc_layers", "dec_layers"):
            stack, _, *field = parts
            out[f"['{stack}']" + "".join(f"['{f}']" for f in field)] = (
                (len(getattr(model, stack)), *p.shape), dt)
        else:
            out["".join(f"['{f}']" for f in parts)] = (tuple(p.shape), dt)
    return out


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_param_layout_matches_reference_tree(get):
    """The port's module holds the reference tree's fields, shapes and
    dtypes (the full config on the ``meta`` device: nothing allocated),
    as many parameters, and ``num_params`` within 2 % of them (the
    reference's ``test_param_counts_match_config_estimates``)."""
    rcfg, tcfg = getattr(r_configs, get)(ARCH), getattr(t_configs, get)(ARCH)
    tree = jax.eval_shape(lambda key: r_whisper.init_params(rcfg, key)[0], jax.random.PRNGKey(0))
    model = t_whisper.Whisper(tcfg, "meta")
    assert _module_layout(model) == _tree_layout(tree)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(math.prod(s.shape) for s in jax.tree.leaves(tree))
    assert abs(n - tcfg.num_params()) / n < 0.02


def test_published_config():
    t = t_configs.get_config(ARCH)
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.hd, t.d_ff) == (4, 384, 6, 6, 64, 1536)
    assert (t.vocab, t.n_frames, t.max_target, t.tie_embeddings) == (51865, 1500, 32769, True)
    assert t.num_params() == 49_031_424
    assert t.param_dtype == t.compute_dtype == torch.bfloat16
    # the builds the card runs it on: B6 at head dim 64, the smoke's at 16
    assert t.hd in flash_kernel.HEAD_DIMS
    assert t_configs.get_smoke_config(ARCH).hd in flash_kernel.HEAD_DIMS


# --------------------------------------------------------- common blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 7, 48) * 3 + 1).astype(np.float32)
    w = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w, b)]
    got = t_common.layer_norm(*tt, 1e-5)
    assert got.dtype == getattr(torch, dtype)
    want = r_common.layer_norm(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w, b)), 1e-5)
    # float32: the same ops in another order; bf16: one output rounding (2^-8 relative)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5 if dtype == "float32" else 5e-2, rtol=0)


@pytest.mark.parametrize("n,d", [(32, 64), (1500, 384)])
def test_sinusoidal_positions_match_reference(n, d):
    got = t_common.sinusoidal_positions(n, d)
    want = np.asarray(r_common.sinusoidal_positions(n, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (n, d)
    # interleaved: sin in the even columns, cos in the odd ones
    assert torch.equal(got[0, 0::2], torch.zeros(d // 2)) and torch.equal(got[0, 1::2], torch.ones(d // 2))
    # sin and cos of arguments up to n rad: the libraries' last-ulp
    # differences in exp and sin grow with the argument (float32 spacing
    # at 1500 is 1.2e-4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * n, rtol=0)


def _naive(q, k, v, causal, kv_len=None):
    """The reference test's naive attention (``tests/test_attention.py``)."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    kr, vr = jnp.repeat(k, H // G, 2), jnp.repeat(v, H // G, 2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(D)
    kpos = jnp.arange(k.shape[1])
    if causal:
        s = jnp.where((jnp.arange(Sq)[:, None] >= kpos[None, :])[None, None], s, -1e30)
    if kv_len is not None:
        s = jnp.where((kpos[None, :] < kv_len[:, None])[:, None, None, :], s, -1e30)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), vr)


@pytest.mark.parametrize("sq,sk,h,gdiv,block,causal", [
    (7, 30, 4, 2, 8, False), (30, 7, 6, 1, 4, False), (24, 48, 2, 2, 16, False),
    (13, 13, 6, 2, 4, True), (1, 33, 4, 1, 8, False),
])
def test_blockwise_matches_naive_and_reference(sq, sk, h, gdiv, block, causal):
    """The reference's ``test_blockwise_matches_naive`` on the port's
    ``blockwise_attention``: Sq != Sk without a mask (cross attention),
    and a causal Sq == Sk case."""
    rng = np.random.RandomState(sq * 100 + sk)
    q = rng.randn(2, sq, h, 8).astype(np.float32)
    k = rng.randn(2, sk, h // gdiv, 8).astype(np.float32)
    v = rng.randn(2, sk, h // gdiv, 8).astype(np.float32)
    got = t_common.blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, block_k=block)
    want = _naive(*map(jnp.asarray, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5 * sk + 1e-5)
    ref = r_common.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=causal, block_k=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)


def test_decode_attention_matches_naive():
    rng = np.random.RandomState(0)
    q = rng.randn(3, 1, 8, 16).astype(np.float32)
    k = rng.randn(3, 33, 2, 16).astype(np.float32)
    v = rng.randn(3, 33, 2, 16).astype(np.float32)
    kv_len = np.array([5, 17, 33], np.int32)
    got = t_common.decode_attention(*map(torch.from_numpy, (q, k, v, kv_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(_naive(*map(jnp.asarray, (q, k, v)), False,
                                                                jnp.asarray(kv_len))), atol=1e-4)


def test_blockwise_kv_len_masking():
    """Keys at or past kv_len take no part, whatever they hold."""
    rng = np.random.RandomState(1)
    q = rng.randn(2, 4, 2, 8).astype(np.float32)
    k = rng.randn(2, 32, 2, 8).astype(np.float32)
    v = rng.randn(2, 32, 2, 8).astype(np.float32)
    kv_len = torch.tensor([9, 20])
    got = t_common.blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal=False, kv_len=kv_len, block_k=8)
    want = _naive(*map(jnp.asarray, (q, k, v)), False, jnp.asarray(kv_len.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    k2 = k.copy()
    k2[:, -5:] = 1e3
    got2 = t_common.blockwise_attention(*map(torch.from_numpy, (q, k2, v)), causal=False, kv_len=kv_len, block_k=8)
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-4)


# ----------------------------------------------------------------- model


def test_forward_prefill_and_decode_match_reference(pair):
    rcfg, params, tcfg, model, batch = pair
    bf16 = tcfg.compute_dtype == torch.bfloat16
    xcfg = dataclasses.replace(rcfg, compute_dtype=jnp.float32)  # the reference's float32 compute
    acc = Accuracy()
    M = batch["tokens"].shape[1] + 4
    with torch.inference_mode():
        logits = model(T(batch))
        last, cache = model.prefill(T(batch), max_len=M)
    want = r_whisper.forward(rcfg, params, J(batch))
    close(logits, want, bf16)
    r_last, r_cache = r_whisper.prefill(rcfg, params, J(batch), max_len=M)
    close(last, r_last, bf16)
    assert set(cache) == set(r_cache)
    for key in CACHE_KEYS:
        assert tuple(cache[key].shape) == r_cache[key].shape, key
        assert str(cache[key].dtype).removeprefix("torch.") == r_cache[key].dtype.name, key
        close(cache[key], r_cache[key], bf16)
    assert cache["length"] == int(r_cache["length"]) == batch["tokens"].shape[1]
    if bf16:
        acc.add("forward", logits, want, r_whisper.forward(xcfg, params, J(batch)))
        x_last, x_cache = r_whisper.prefill(xcfg, params, J(batch), max_len=M)
        acc.add("logits", last, r_last, x_last)
        for key in CACHE_KEYS:
            acc.add(key, cache[key], r_cache[key], x_cache[key])
    for step in range(2):  # two decode steps, each on the reference's greedy token
        nxt = np.argmax(f32(r_last), -1)[:, None]
        r_last, r_cache = r_whisper.decode_step(rcfg, params, r_cache, jnp.asarray(nxt, jnp.int32))
        with torch.inference_mode():
            d_logits, cache = model.decode_step(cache, torch.from_numpy(nxt))
        close(d_logits, r_last, bf16)
        for key in CACHE_KEYS:
            close(cache[key], r_cache[key], bf16)
        assert cache["length"] == int(r_cache["length"]) == batch["tokens"].shape[1] + step + 1
        if bf16:
            x_last, x_cache = r_whisper.decode_step(xcfg, params, x_cache, jnp.asarray(nxt, jnp.int32))
            acc.add("logits", d_logits, r_last, x_last)
            for key in ("self_k", "self_v"):
                acc.add(key, cache[key], r_cache[key], x_cache[key])
    acc.check()


def test_one_token_prompt_takes_decode_attention(pair, monkeypatch):
    """With S = 1 the prefill's cross attention is the reference's
    single-query branch (``decode_attention``), not a full attention."""
    rcfg, params, tcfg, model, batch = pair
    one = dict(batch, tokens=batch["tokens"][:, :1])
    calls = []
    real = t_common.decode_attention
    monkeypatch.setattr(t_common, "decode_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        last, cache = model.prefill(T(one), max_len=4)
    assert len(calls) == tcfg.n_layers
    r_last, r_cache = r_whisper.prefill(rcfg, params, J(one), max_len=4)
    bf16 = tcfg.compute_dtype == torch.bfloat16
    close(last, r_last, bf16)
    close(cache["cross_k"], r_cache["cross_k"], bf16)


def test_smoke_decode_runs(pair):
    """The audio case of the reference's ``test_smoke_decode_runs``."""
    _, _, tcfg, model, _ = pair
    batch = make_batch(tcfg, 2, 8, 3)
    with torch.inference_mode():
        logits, cache = model.prefill(T(batch), max_len=24)
        assert tuple(logits.shape) == (2, tcfg.vocab)
        tok = logits.argmax(-1)[:, None]
        for _ in range(2):
            logits, cache = model.decode_step(cache, tok)
            assert torch.isfinite(logits).all()
            tok = logits.argmax(-1)[:, None]


def test_prefill_then_decode_reproduces_forward(pair):
    _, _, tcfg, model, batch = pair
    tt = T(batch)
    S = tt["tokens"].shape[1] - 3
    bound = SELF_TOL if tcfg.compute_dtype == torch.float32 else BF16_RTOL
    with torch.inference_mode():
        full = model(tt)
        last, cache = model.prefill(dict(tt, tokens=tt["tokens"][:, :S]), max_len=S + 3)
        steps = [last]
        for t in range(S, S + 3):
            logits, cache = model.decode_step(cache, tt["tokens"][:, t : t + 1])
            steps.append(logits)
    for i, got in enumerate(steps[:-1]):
        if tcfg.compute_dtype == torch.float32:
            np.testing.assert_allclose(f32(got), f32(full[:, S - 1 + i]), atol=bound, rtol=0)
        else:
            assert rel_l2(got, full[:, S - 1 + i]) <= bound, i


def _reference_logits(rcfg, params, batch, path, max_len):
    """The reference's logits along a token path (B, n - 1): the prompt's
    prefill, then decode on each of the path's tokens."""
    logits, cache = r_whisper.prefill(rcfg, params, J(batch), max_len=max_len)
    out = [f32(logits)]
    for step in range(path.shape[1]):
        logits, cache = r_whisper.decode_step(rcfg, params, cache, jnp.asarray(path[:, step : step + 1]))
        out.append(f32(logits))
    return np.stack(out, 1)


def test_generate_matches_reference_tokens(pair):
    rcfg, params, tcfg, model, batch = pair
    n, max_len = 10, 32
    want = np.asarray(r_serve.LMServer(rcfg, params, max_len=max_len).generate(J(batch), n))
    got = t_serve.LMServer(tcfg, model, max_len=max_len, device="cpu").generate(batch, n)
    assert got.shape == want.shape == (2, n) and got.dtype == np.int32
    if np.array_equal(got, want):
        return
    ref = _reference_logits(rcfg, params, batch, want[:, :-1], max_len)
    tie = DTYPES["bf16" if tcfg.compute_dtype == torch.bfloat16 else "f32"][2]
    if tie is None:  # the reference's own bf16 rounding error, by row and step
        exact = _reference_logits(dataclasses.replace(rcfg, compute_dtype=jnp.float32), params, batch,
                                  want[:, :-1], max_len)
        margin = np.abs(ref - exact).max(-1)
    else:
        margin = np.full(ref.shape[:2], tie)
    for row in range(got.shape[0]):
        bad = np.nonzero(got[row] != want[row])[0]
        if bad.size:
            step = int(bad[0])
            gap = ref[row, step, want[row, step]] - ref[row, step, got[row, step]]
            assert gap <= margin[row, step], (row, step, gap, margin[row, step])
            warnings.warn(f"row {row}: near tie at step {step} (gap {gap:.3g}, margin "
                          f"{margin[row, step]:.3g}); later tokens of this row not compared")


def test_blockwise_route_equals_kernel_route_on_cpu(pair):
    _, _, tcfg, model, batch = pair
    plain = t_whisper.Whisper(dataclasses.replace(tcfg, attn_impl="blockwise"), "cpu")
    plain.load_state_dict(model.state_dict())
    with torch.inference_mode():
        assert torch.equal(plain(T(batch)), model(T(batch)))
        (l_p, c_p), (l_k, c_k) = plain.prefill(T(batch)), model.prefill(T(batch))
    assert torch.equal(l_p, l_k)
    for key in CACHE_KEYS:
        assert torch.equal(c_p[key], c_k[key]), key
    bad = t_whisper.Whisper(dataclasses.replace(tcfg, attn_impl="pallas"), "cpu")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        bad.prefill(T(batch))


def test_limits_raise_where_the_reference_clamps(pair):
    """Past the cache's M or the position table's max_target the
    reference clamps its slices and answers wrongly; the port raises."""
    _, _, tcfg, model, batch = pair
    tt = T(batch)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="cannot hold a prompt"):
            model.prefill(tt, max_len=tt["tokens"].shape[1] - 1)
        _, cache = model.prefill(dict(tt, tokens=tt["tokens"][:, :8]), max_len=9)
        _, cache = model.decode_step(cache, tt["tokens"][:, 8:9])
        with pytest.raises(ValueError, match="KV cache full"):
            model.decode_step(cache, tt["tokens"][:, 9:10])
        long = torch.zeros((2, tcfg.max_target + 1), dtype=torch.long)
        with pytest.raises(ValueError, match="max_target"):
            model.prefill(dict(tt, tokens=long), max_len=tcfg.max_target + 2)
        with pytest.raises(ValueError, match="max_target"):
            model(dict(tt, tokens=long))
        # a cache longer than the table: decode stops at max_target
        _, cache = model.prefill(dict(tt, tokens=long[:, : tcfg.max_target]), max_len=tcfg.max_target + 1)
        with pytest.raises(ValueError, match="max_target"):
            model.decode_step(cache, tt["tokens"][:, :1])
    with pytest.raises(ValueError, match="KV cache full"):
        t_serve.LMServer(tcfg, model, max_len=batch["tokens"].shape[1] + 1, device="cpu").generate(batch, 3)
    with pytest.raises(TypeError, match="batch dict"):
        t_serve.LMServer(tcfg, model, device="cpu").generate(batch["tokens"], 2)


def _broken(tree, what):
    tree = {k: ({kk: (dict(vv) if isinstance(vv, dict) else vv) for kk, vv in v.items()}
                if isinstance(v, dict) else v) for k, v in tree.items()}
    if what == "bk":
        tree["enc_layers"]["attn"]["bk"] = tree["enc_layers"]["attn"]["bq"]
    elif what == "missing":
        del tree["dec_layers"]["cross_attn"]["bo"]
    elif what == "shape":
        tree["dec_layers"]["mlp"]["w1"] = tree["dec_layers"]["mlp"]["w1"][:, :, :-1]
    elif what == "dtype":
        tree["dec_pos"] = tree["dec_pos"].astype(np.float16)
    elif what == "ln_post":
        tree["enc_ln_post"] = dict(tree["enc_ln_post"], g=tree["enc_ln_post"]["w"])
    elif what == "stack":
        tree["enc_layers"]["ln1"]["w"] = tree["enc_layers"]["ln1"]["w"][:1]
    return tree


@pytest.mark.parametrize("what,match", [
    ("bk", r"enc_layers.attn hold .*extra \['bk'\]"), ("missing", r"dec_layers.cross_attn .*missing \['bo'\]"),
    ("shape", r"dec_layers.mlp.w1\[0\]"), ("dtype", "dec_pos"), ("ln_post", r"enc_ln_post .*extra \['g'\]"),
    ("stack", "enc_layers.ln1.w stacks"),
])
def test_params_from_numpy_names_the_wrong_field(pair, what, match):
    _, params, tcfg, _, _ = pair
    tree = _broken(jax.tree.map(np.asarray, params), what)
    with pytest.raises(ValueError, match=match):
        whisper_params_from_numpy(tree, tcfg, device="cpu")


def test_entry_points_need_a_device(pair):
    _, _, tcfg, model, batch = pair
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.LMServer(tcfg, model)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_whisper.init_params(tcfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            whisper_params_from_numpy({}, tcfg)
    other = t_whisper.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert all(not p.requires_grad for p in other.parameters())
    assert torch.equal(other.enc_ln_post.w, torch.ones_like(other.enc_ln_post.w))
    assert not other.dec_layers[0].self_attn.bq.any()
    out = t_serve.LMServer(tcfg, other, max_len=16, device="cpu").generate(batch, 3)
    assert out.shape == (2, 3) and ((0 <= out) & (out < tcfg.vocab)).all()
