"""The port's mixture-of-experts layer and Arctic-style MoE LM against the
JAX reference (``repro.models.moe``) on the reference's smoke config.

The reference's ``init_params`` tree is carried into the port with
``interop.moe_params_from_numpy``.  Routing is compared as integers:
``_topk_dispatch`` on the same probabilities gives the reference's
dispatch and combine bit for bit (ties to the lower expert index, as
``lax.top_k``), and in float32 every layer's top-k indices equal the
reference's.  Float outputs: relative L2 <= 1e-5 in float32.

bfloat16 (ROADMAP C.16).  A token whose k-th and (k+1)-th router
probabilities nearly tie can pick another expert under a rounding
difference, and its MoE output then differs in full (and, through the
slot-major queue, the capacity drops of the tokens behind it): at the
smoke depth one such flip moves the logits by ~0.1 relative, more than
all the rounding together.  So the bf16 run replays the reference's
routing: the port's top k of each ``moe_block`` call is the reference's
indices, gathered from the port's own probabilities (``port_routing``),
and then the logits and caches are held as ROADMAP C.15 holds Zamba-2:
relative L2 <= 5e-2 against the reference's bf16, and no farther from the
reference's float32-compute run than 1.25x the reference's own bf16
distance, pooled.  Each routing flip (a token whose own top-k set
differs from the reference's) is counted per layer and must be a near
tie: the reference's own probability of the port's pick lies within
2 x (the reference's + the port's own bf16 rounding error on that
token's probabilities, each their largest distance from the reference's
float32-compute run) of its k-th largest, the most by which rounding
can swap two experts; the router probabilities as a whole are held to
the 1.25x pool like the logits.

``test_torch_mla.py`` runs the whole-model checks here on DeepSeek-V2's
MLA model through ``make_pair`` and ``check_whole_model``.
"""

import contextlib
import dataclasses
import math
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro.models import mla as r_mla  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import mla as t_mla  # noqa: E402
from repro_torch.models import model_api  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

ARCH = "arctic-480b"
BF16_ACCURACY = 1.25  # the port's bf16 error over the reference's own
NO_DROP_ATOL = 3e-4  # the reference's own prefill + decode vs forward bound
TRUNC_STD = 0.8796256610342398  # std of the standard normal truncated to [-2, 2]
# (reference overrides, port overrides, relative L2 tolerance)
DTYPES = {
    "f32": ({}, {}, 1e-5),
    "bf16": (
        {"param_dtype": jnp.bfloat16, "compute_dtype": jnp.bfloat16},
        {"param_dtype": torch.bfloat16, "compute_dtype": torch.bfloat16},
        5e-2,
    ),
}
# reference module, loader, port module
MODELS = {
    "arctic-480b": (r_moe, interop.moe_params_from_numpy, t_moe),
    "deepseek-v2-lite-16b": (r_mla, interop.mla_params_from_numpy, t_mla),
}


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def f32(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@dataclasses.dataclass
class Pair:
    arch: str
    dtype: str
    rmod: types.ModuleType
    rcfg: object
    params: dict
    tcfg: object
    model: torch.nn.Module
    toks: np.ndarray
    tol: float
    next_toks: list | None = None  # the decode steps' tokens, set by check_whole_model


def make_pair(arch: str, dtype: str, seed: int = 0, **overrides) -> Pair:
    """The reference's smoke model (``remat`` off: the same arithmetic, and
    routing can be recorded), the port's holding its weights, and a
    (2, 37) prompt, all from ``seed``."""
    r_over, t_over, tol = DTYPES[dtype]
    rcfg = r_configs.get_smoke_config(arch, remat=False, **r_over, **overrides)
    tcfg = t_configs.get_smoke_config(arch, **t_over, **overrides)
    rmod, load, _ = MODELS[arch]
    params, _ = rmod.init_params(rcfg, jax.random.PRNGKey(seed))
    model = load(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.RandomState(seed).randint(0, tcfg.vocab, (2, 37))
    return Pair(arch, dtype, rmod, rcfg, params, tcfg, model, toks, tol)


# ------------------------------------------------------------- routing


@contextlib.contextmanager
def reference_routing():
    """Records the reference's router probabilities, one (G, gs, E) array
    per ``moe_block`` call, in call order (layer by layer)."""
    rec = []
    orig = r_moe._topk_dispatch

    def wrapped(cfg, probs):
        jax.debug.callback(lambda p: rec.append(np.asarray(p)), probs, ordered=True)
        return orig(cfg, probs)

    r_moe._topk_dispatch = wrapped
    try:
        yield rec
        jax.effects_barrier()
    finally:
        r_moe._topk_dispatch = orig


@contextlib.contextmanager
def port_routing(replay=None):
    """Records the port's router probabilities per ``moe_block`` call; with
    ``replay`` (the reference's, per call) each call's top k is the
    reference's indices, gathered from the port's own probabilities."""
    rec = []
    orig = t_moe._top_k

    def top_k(probs, k):
        rec.append(probs.clone())
        if replay is None:
            return orig(probs, k)
        idx = torch.from_numpy(np.array(ref_top_k(replay[len(rec) - 1], k))).long()
        return probs.gather(-1, idx), idx

    t_moe._top_k = top_k
    try:
        yield rec
    finally:
        t_moe._top_k = orig


def ref_top_k(probs, k) -> np.ndarray:
    return np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1])


def routing_flips(port, ref, k, exact) -> list[list[tuple[int, float, float]]]:
    """Per call, the tokens whose top-k set differs between the port's
    probabilities and the reference's: (token, gap, margin).  gap: the
    reference's k-th largest probability over its probability of the
    port's lowest pick outside its own set.  margin: 2 x (the reference's
    + the port's own rounding error on the token), each the largest
    distance of its probabilities from ``exact``'s, the reference's
    float32-compute run: two experts' order can swap by at most that."""
    out = []
    for call, (tp, rp) in enumerate(zip(port, ref)):
        rp = rp.reshape(-1, rp.shape[-1])
        tp = tp.numpy().reshape(rp.shape)
        xp = exact[call].reshape(rp.shape)
        ri = ref_top_k(rp, k)
        ti = t_moe._top_k(torch.from_numpy(tp), k)[1].numpy()
        margin = 2 * (np.abs(rp - xp).max(-1) + np.abs(tp - xp).max(-1))
        flips = []
        for t in range(len(rp)):
            extra = sorted(set(ti[t]) - set(ri[t]))
            if extra:
                gap = float(rp[t, ri[t, -1]] - min(rp[t, e] for e in extra))
                flips.append((t, gap, float(margin[t])))
        out.append(flips)
    return out


class Accuracy:
    """In bf16, the port's and the reference's distances from the
    reference's float32-compute run, pooled by name; ``check`` holds each
    pool to ``BF16_ACCURACY``."""

    def __init__(self):
        self.sq = {}

    def add(self, name, got, want, exact):
        e = f32(exact).astype(np.float64)
        port, ref = self.sq.get(name, (0.0, 0.0))
        self.sq[name] = (
            port + float(np.sum((f32(got) - e) ** 2)),
            ref + float(np.sum((f32(want) - e) ** 2)),
        )

    def ratios(self) -> dict:
        return {n: math.sqrt(p / r) for n, (p, r) in self.sq.items()}

    def check(self):
        for name, ratio in self.ratios().items():
            assert ratio <= BF16_ACCURACY, (name, ratio)


def _calls(pair: Pair, rcfg, jt, model=None):
    """Forward, prefill and two decode steps (on the reference's greedy
    tokens ``jt``'s continuation) of the reference (``model`` None) or the
    port; returns [(name, logits-like outputs, cache or None), ...]."""
    M = pair.toks.shape[1] + 4
    if model is None:
        logits, aux = pair.rmod.forward(rcfg, pair.params, jt)
        out = [("forward", logits, aux, None)]
        last, cache = pair.rmod.prefill(rcfg, pair.params, jt, max_len=M)
        out.append(("prefill", last, None, cache))
        for step in range(2):
            last, cache = pair.rmod.decode_step(rcfg, pair.params, cache, pair.next_toks[step])
            out.append((f"decode {step}", last, None, cache))
        return out
    tt = torch.from_numpy(pair.toks)
    with torch.inference_mode():
        logits, aux = model(tt)
        out = [("forward", logits, aux, None)]
        last, cache = model.prefill(tt, max_len=M)
        out.append(("prefill", last, None, {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                                            for k, v in cache.items()}))
        for step in range(2):
            last, cache = model.decode_step(cache, torch.from_numpy(np.asarray(pair.next_toks[step])))
            out.append((f"decode {step}", last, None, {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                                                       for k, v in cache.items()}))
    return out


def check_whole_model(pair: Pair) -> dict:
    """Forward (logits, aux), prefill (last logits, the cache key by key)
    and two decode steps of the port against the reference's, with the
    routing of every ``moe_block`` call: equal in float32, replayed and
    counted in bf16 (module docstring).  Returns the bf16 readings."""
    rcfg, tcfg, tol = pair.rcfg, pair.tcfg, pair.tol
    bf16 = pair.dtype == "bf16"
    jt = jnp.asarray(pair.toks, jnp.int32)
    # the decode tokens: the reference's greedy picks after the prompt
    last, cache = pair.rmod.prefill(rcfg, pair.params, jt, max_len=pair.toks.shape[1] + 4)
    nxt = [np.argmax(f32(last), -1)[:, None].astype(np.int32)]
    last, _ = pair.rmod.decode_step(rcfg, pair.params, cache, jnp.asarray(nxt[0]))
    nxt.append(np.argmax(f32(last), -1)[:, None].astype(np.int32))
    pair.next_toks = [jnp.asarray(n) for n in nxt]

    with reference_routing() as r_rec:
        ref = _calls(pair, rcfg, jt)
    with port_routing(replay=r_rec if bf16 else None) as t_rec:
        port = _calls(pair, rcfg, jt, pair.model)
    assert len(t_rec) == len(r_rec) == 4 * (tcfg.n_layers - tcfg.first_k_dense)

    readings = {}
    acc = Accuracy()
    if bf16:
        xcfg = dataclasses.replace(rcfg, compute_dtype=jnp.float32)
        with reference_routing() as x_rec:
            exact = _calls(pair, xcfg, jt)
    for i, ((name, r_out, r_aux, r_cache), (_, t_out, t_aux, t_cache)) in enumerate(zip(ref, port)):
        assert rel_l2(f32(t_out), f32(r_out)) <= tol, name
        if r_aux is not None:
            assert abs(float(t_aux) - float(r_aux)) <= (1e-6 if not bf16 else 1e-2) * abs(float(r_aux)), name
        if bf16:
            acc.add("forward logits" if name == "forward" else "prefill and decode logits",
                    t_out, r_out, exact[i][1])
        if r_cache is None:
            continue
        assert set(t_cache) == set(r_cache), name
        assert t_cache["length"] == int(r_cache["length"]), name
        for key in sorted(k for k in r_cache if k != "length"):
            got, want = t_cache[key], r_cache[key]
            assert tuple(got.shape) == want.shape, (name, key)
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name, (name, key)
            assert rel_l2(f32(got), f32(want)) <= tol, (name, key)
            if bf16:
                acc.add(key, got, want, exact[i][3][key])

    k = tcfg.top_k
    n_moe = tcfg.n_layers - tcfg.first_k_dense
    if not bf16:
        for call, (tp, rp) in enumerate(zip(t_rec, r_rec)):
            want = ref_top_k(rp, k)
            got = t_moe._top_k(tp, k)[1].numpy()
            assert np.array_equal(got, want), f"call {call} (layer {call % n_moe}) routes differently"
        return readings
    for tp, rp, xp in zip(t_rec, r_rec, x_rec):
        acc.add("router probabilities", tp, rp, xp)
    acc.check()
    flips = routing_flips(t_rec, r_rec, k, x_rec)
    per_layer = [0] * n_moe
    for call, fl in enumerate(flips):
        per_layer[call % n_moe] += len(fl)
        for t, gap, margin in fl:
            assert gap <= margin, f"call {call} token {t}: not a near tie (gap {gap:.3g}, margin {margin:.3g})"
    readings.update(acc.ratios(), flips_per_layer=per_layer,
                    logits_rel_l2=rel_l2(f32(port[0][1]), f32(ref[0][1])))
    warnings.warn(f"{pair.arch} bf16: routing flips per MoE layer {per_layer}, all near ties; "
                  f"ratios {acc.ratios()}")
    return readings


def check_generate(pair: Pair) -> None:
    """Greedy ``LMServer.generate`` (float32) gives the reference
    server's tokens."""
    n, max_len = 8, 64
    want = np.asarray(
        r_serve.LMServer(pair.rcfg, pair.params, max_len=max_len).generate(
            jnp.asarray(pair.toks, jnp.int32), n)
    )
    got = t_serve.LMServer(pair.tcfg, pair.model, max_len=max_len, device="cpu").generate(pair.toks, n)
    assert got.dtype == np.int32 and got.shape == want.shape == (2, n)
    np.testing.assert_array_equal(got, want)


def check_no_drop_consistency(arch: str) -> None:
    """With capacity 4.0 nothing is dropped: the port's prefill and one
    decode step reproduce its own forward (the reference's
    ``test_moe_consistency_no_drop`` / ``test_mla_consistency_no_drop``)."""
    pair = make_pair(arch, "f32", capacity_factor=4.0)
    tt = torch.from_numpy(np.random.RandomState(1).randint(0, pair.tcfg.vocab, (2, 16)))
    with torch.inference_mode():
        full, _ = pair.model(tt)
        last, cache = pair.model.prefill(tt[:, :8], max_len=16)
        step, _ = pair.model.decode_step(cache, tt[:, 8:9])
    assert float((last - full[:, 7]).abs().max()) <= NO_DROP_ATOL
    assert float((step - full[:, 8]).abs().max()) <= NO_DROP_ATOL


def check_cache_overflow(pair: Pair) -> None:
    model, toks = pair.model, torch.from_numpy(pair.toks)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="cannot hold a prompt"):
            model.prefill(toks, max_len=toks.shape[1] - 1)
        _, cache = model.prefill(toks[:, :8], max_len=9)
        _, cache = model.decode_step(cache, toks[:, 8:9])
        assert cache["length"] == 9
        with pytest.raises(ValueError, match="KV cache full"):
            model.decode_step(cache, toks[:, 9:10])
    with pytest.raises(ValueError, match="KV cache full"):
        t_serve.LMServer(pair.tcfg, model, max_len=toks.shape[1] + 1, device="cpu").generate(pair.toks, 3)


def check_entry_points_need_a_device(pair: Pair, init_params) -> None:
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.LMServer(pair.tcfg, pair.model)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(pair.tcfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            MODELS[pair.arch][1]({}, pair.tcfg)
    other = init_params(pair.tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert all(not p.requires_grad for p in other.parameters())
    out = t_serve.LMServer(pair.tcfg, other, device="cpu").generate(pair.toks, 3)
    assert out.shape == (2, 3) and ((0 <= out) & (out < pair.tcfg.vocab)).all()


def check_config_mirrors_reference(arch: str, get: str) -> None:
    r = getattr(r_configs, get)(arch)
    t = getattr(t_configs, get)(arch)
    r_fields = {f.name for f in dataclasses.fields(r)}
    for f in dataclasses.fields(t):
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(getattr(t, f.name)).removeprefix("torch.") == jnp.dtype(getattr(r, f.name)).name
        elif f.name != "attn_impl":  # the port's own route
            assert f.name in r_fields and getattr(t, f.name) == getattr(r, f.name), f.name
    for name in ("hd", "qk_dim"):
        if hasattr(r, name):
            assert getattr(t, name) == getattr(r, name), name
    assert t.num_params() == r.num_params() and t.active_params() == r.active_params()
    assert t.family == "moe" and t.attn_impl == "kernel"


def _tree_layout(tree) -> dict:
    return {jax.tree_util.keystr(path): (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _module_layout(model) -> dict:
    """The port's parameters in the reference tree's layout: stacked layer
    fields with the layer count in front."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        dt = str(p.dtype).removeprefix("torch.")
        if len(parts) == 1:
            out[f"['{name}']"] = (tuple(p.shape), dt)
            continue
        stack, _, *field = parts
        key = f"['{stack}']" + "".join(f"['{f}']" for f in field)
        n = len(getattr(model, stack))
        out[key] = ((n, *p.shape), dt)
    return out


def check_param_layout(arch: str, get: str) -> None:
    """The port's module holds the reference tree's fields, shapes and
    dtypes (the full config on the ``meta`` device: nothing allocated),
    and as many parameters."""
    rmod, _, tmod = MODELS[arch]
    rcfg = getattr(r_configs, get)(arch)
    tcfg = getattr(t_configs, get)(arch)
    tree = jax.eval_shape(lambda key: rmod.init_params(rcfg, key)[0], jax.random.PRNGKey(0))
    model = (tmod.MoE if tmod is t_moe else tmod.MLA)(tcfg, "meta")
    assert _module_layout(model) == _tree_layout(tree)
    leaves = sum(math.prod(s.shape) for s in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == leaves


# ---------------------------------------------------------------- tests


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request):
    return make_pair(ARCH, request.param)


def _probs(shape, seed, ties=False):
    rng = np.random.RandomState(seed)
    logits = rng.randn(*shape).astype(np.float32)
    if ties:  # few distinct values: exact ties inside most tokens' top k
        logits = np.round(logits * 2) / 2
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def dispatch_matches_reference(rcfg, tcfg, probs) -> tuple[np.ndarray, np.ndarray]:
    rd, rc = r_moe._topk_dispatch(rcfg, jnp.asarray(probs))
    td, tc = t_moe._topk_dispatch(tcfg, torch.from_numpy(probs))
    assert td.dtype == torch.float32 and tuple(td.shape) == rd.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    return td.numpy(), tc.numpy()


@pytest.mark.parametrize("case", ["smoke", "capacity 0.5", "norm_topk", "ties"])
def test_dispatch_bitwise_equal_to_reference(case):
    over = {"capacity 0.5": {"capacity_factor": 0.5}, "norm_topk": {"norm_topk": True}}.get(case, {})
    rcfg = r_configs.get_smoke_config(ARCH, **over)
    tcfg = t_configs.get_smoke_config(ARCH, **over)
    probs = _probs((2, 64, tcfg.n_experts), seed=3, ties=case == "ties")
    d, c = dispatch_matches_reference(rcfg, tcfg, probs)
    C = d.shape[-1]
    assert C == max(int(tcfg.capacity_factor * 64 * tcfg.top_k / tcfg.n_experts), 1)
    assert d.sum(axis=(1, 3)).max() <= C  # no expert over its capacity
    if case == "capacity 0.5":
        assert d.sum() < 2 * 64 * tcfg.top_k  # something dropped
    if case == "ties":
        srt = np.sort(probs, -1)[..., ::-1]
        assert (srt[..., tcfg.top_k - 1] == srt[..., tcfg.top_k]).sum() > 10  # ties at the cut
    if case == "norm_topk":
        kept = c.sum(axis=(2, 3))[d.sum(axis=(2, 3)) == tcfg.top_k]
        np.testing.assert_allclose(kept, 1.0, rtol=1e-6)


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15]])
    vals, idx = t_moe._top_k(probs, 3)
    assert idx.tolist() == [[0, 1, 3]] == ref_top_k(probs.numpy(), 3).tolist()
    assert vals.tolist() == [[0.25, 0.25, 0.25]]


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_moe_block_matches_reference(arch):
    """The MoE layer alone (arctic: no shared experts; deepseek: one
    shared expert): y within 1e-5, aux within 1e-6."""
    rcfg = r_configs.get_smoke_config(arch)
    tcfg = t_configs.get_smoke_config(arch)
    mp_r = jax.tree.map(np.asarray, r_moe.common.split_tree(r_moe.moe_init(rcfg, jax.random.PRNGKey(2)))[0])
    mp = t_moe.MoEParams(tcfg, "cpu")
    assert set(mp_r) == {n for n, _ in mp.named_parameters()} == set(t_moe.moe_shapes(tcfg))
    assert ("ws_gate" in mp_r) == bool(tcfg.n_shared_experts)
    with torch.no_grad():
        for name, arr in mp_r.items():
            getattr(mp, name).copy_(torch.from_numpy(np.array(arr)))
    assert mp.router.dtype == torch.float32
    x = np.random.RandomState(4).randn(2, 48, tcfg.d_model).astype(np.float32)
    y_r, aux_r = r_moe.moe_block(rcfg, mp_r, jnp.asarray(x))
    with torch.inference_mode():
        y, aux = t_moe.moe_block(tcfg, mp, torch.from_numpy(x))
    assert rel_l2(y.numpy(), y_r) <= 1e-5
    assert abs(float(aux) - float(aux_r)) <= 1e-6 * abs(float(aux_r))


def test_forward_prefill_and_decode_match_reference(pair):
    check_whole_model(pair)


def test_generate_matches_reference_tokens():
    check_generate(make_pair(ARCH, "f32"))


def test_consistency_no_drop():
    check_no_drop_consistency(ARCH)


def test_kernel_route_equals_blockwise_on_cpu(pair):
    """On CPU tensors B6's route runs its plain version, so the
    'blockwise' route gives the same bits."""
    plain = t_moe.MoE(dataclasses.replace(pair.tcfg, attn_impl="blockwise"), "cpu")
    plain.load_state_dict(pair.model.state_dict())
    tt = torch.from_numpy(pair.toks)
    with torch.inference_mode():
        (l_p, a_p), (l_k, a_k) = plain(tt), pair.model(tt)
        (p_p, c_p), (p_k, c_k) = plain.prefill(tt), pair.model.prefill(tt)
    assert torch.equal(l_p, l_k) and torch.equal(a_p, a_k) and torch.equal(p_p, p_k)
    assert torch.equal(c_p["k"], c_k["k"]) and torch.equal(c_p["v"], c_k["v"])


def test_cache_overflow_raises(pair):
    check_cache_overflow(pair)


def _broken(tree, what):
    tree = {k: v for k, v in tree.items()}
    layers = tree["layers"] = dict(tree["layers"])
    layers["moe"] = dict(layers["moe"])
    if what == "layers.wq":
        layers["wq"] = layers["wq"][:, :, :-1]
    elif what == "layers.moe.router":
        layers["moe"]["router"] = layers["moe"]["router"].astype(jnp.bfloat16)
    elif what == "layers.moe.we_up":
        del layers["moe"]["we_up"]
    elif what == "layers.moe.extra":
        layers["moe"]["ws_gate"] = layers["moe"]["we_gate"][:, 0]
    elif what == "layers.ln3":
        layers["ln3"] = layers["ln3"][:1]
    elif what == "lm_head":
        del tree["lm_head"]
    return tree


@pytest.mark.parametrize(
    "what,match",
    [("layers.wq", r"layers.wq\[0\]"), ("layers.moe.router", r"layers.moe.router\[0\].*float32"),
     ("layers.moe.we_up", r"layers.moe hold.*missing \['we_up'\]"),
     ("layers.moe.extra", r"layers.moe hold.*extra \['ws_gate'\]"),
     ("layers.ln3", "layers.ln3 stacks"), ("lm_head", r"missing \['lm_head'\]")],
)
def test_params_from_numpy_names_the_wrong_field(pair, what, match):
    tree = _broken(jax.tree.map(np.asarray, pair.params), what)
    with pytest.raises(ValueError, match=match):
        interop.moe_params_from_numpy(tree, pair.tcfg, device="cpu")


def test_entry_points_need_a_device(pair):
    check_entry_points_need_a_device(pair, t_moe.init_params)
    assert model_api.get_model(pair.tcfg) is t_moe


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_mirrors_reference(get):
    check_config_mirrors_reference(ARCH, get)


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_param_layout_matches_reference_tree(get):
    check_param_layout(ARCH, get)


def test_published_config():
    t = t_configs.get_config(ARCH)
    assert t.num_params() == 476_850_275_328
    assert t_configs.get_smoke_config(ARCH).num_params() == 423_232
    assert dataclasses.replace(t, n_layers=2).num_params() == 27_681_131_520
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.hd) == (35, 7168, 56, 8, 128)
    assert (t.n_experts, t.top_k, t.moe_d_ff, t.d_ff, t.router_group) == (128, 2, 4864, 4864, 4096)
    assert t.dense_residual and t.param_dtype == t.compute_dtype == torch.bfloat16
    # the build B6 runs it on: head dim 128, a GQA group of 7
    from repro_torch.kernels.flash import kernel as flash_kernel

    assert t.hd in flash_kernel.HEAD_DIMS and t.n_heads % t.n_kv_heads == 0
    shapes = t_moe.layer_shapes(t)
    assert "w_gate" in shapes and "ln3" in shapes
    assert "w_gate" not in t_moe.layer_shapes(dataclasses.replace(t, dense_residual=False))
    assert model_api.model_flops_per_token(t, train=False) == 2.0 * t.active_params()


def test_init_draws_experts_with_the_reference_fan_in():
    """``dense_init`` takes fan_in = shape[0], so an expert tensor (E, ·, ·)
    has std 1/sqrt(E) in the reference; the port draws it one expert at
    a time with that std."""
    cfg = t_configs.get_smoke_config(ARCH, n_experts=16, moe_d_ff=256)
    m = t_moe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mp = m.layers[0].moe
    E, D = cfg.n_experts, cfg.d_model
    for name in ("we_gate", "we_up", "we_down"):
        std = float(getattr(mp, name)[3].std())
        assert abs(std / (TRUNC_STD / math.sqrt(E)) - 1) < 0.03, (name, std)
    assert not torch.equal(mp.we_gate[0], mp.we_gate[1])
    assert mp.router.dtype == torch.float32
    assert abs(float(mp.router.std()) / (TRUNC_STD / math.sqrt(D)) - 1) < 0.05
    assert torch.equal(m.layers[0].ln3, torch.ones(D))
