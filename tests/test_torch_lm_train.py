"""LM training in the port against the JAX reference, on the smoke configs
in float32 on the CPU: the cross-entropy, every family's ``loss_fn`` and
its gradients, the SSD op's backward, the token stream, the train step
and the train loop with its kill-safe resume.

The reference's parameters (``init_params``) are carried into the port
by the ``interop`` loaders, and so are its gradients, which have the
parameters' tree: both modules are then compared by parameter name.
The reference's own ``train_loop`` cannot run under this JAX (its
``constrain`` refuses a spec on the explicit axes ``make_local_mesh``
makes), so the loop is held against the reference's ``make_step_fn``,
jitted and run outside ``activate()``, on the reference's parameters
and its ``batch_at_step`` batches.  ``global_norm`` sums in another
order in the two packages, so the parameters after 4 steps agree to
1e-4, not bitwise; inside the port the restart contract is bitwise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.data import tokens as r_tokens  # noqa: E402
from repro.launch import train as r_train  # noqa: E402
from repro.models import common as r_common  # noqa: E402
from repro.models import model_api as r_model_api  # noqa: E402
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.data import tokens as t_tokens  # noqa: E402
from repro_torch.distributed.fault import FailureInjector, run_with_restarts  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import model_api  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in t_configs.PORTED if a != "sthc_kth"]
# one arch per family, and the loader that carries its tree across
FAMILIES = {
    "qwen2-1.5b": interop.transformer_params_from_numpy,
    "mamba2-370m": interop.mamba2_params_from_numpy,
    "zamba2-2.7b": interop.zamba_params_from_numpy,
    "arctic-480b": interop.moe_params_from_numpy,
    "deepseek-v2-lite-16b": interop.mla_params_from_numpy,
    "whisper-tiny": interop.whisper_params_from_numpy,
    "internvl2-2b": interop.vlm_params_from_numpy,
}
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4  # relative L2, per parameter
PARAM_RTOL = 1e-4  # relative L2, per parameter, after 4 steps
CE_ATOL = 1e-6


def _overrides(arch: str) -> dict:
    """MoE and MLA at a capacity with no drops (C >= the group size)."""
    cfg = t_configs.get_smoke_config(arch)
    if cfg.family == "moe":
        return {"capacity_factor": float(cfg.n_experts)}
    return {}


def _batch_np(cfg, B=2, S=24, seed=1) -> dict:
    rng = np.random.RandomState(seed)
    batch = {
        "tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
    }
    if cfg.family == "audio":
        batch["frames"] = rng.randn(B, cfg.n_frames, cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(B, cfg.n_patches, cfg.d_model).astype(np.float32)
    return batch


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(got - want)
    norm = np.linalg.norm(want)
    return float(diff / norm) if norm > 0 else float(diff)


def _grads(cfg, model, batch) -> dict:
    """The port's loss and its gradients by parameter name."""
    model.requires_grad_(True)
    loss, grads = t_train.loss_and_grads(cfg, model, batch)
    return float(loss), grads


# ---------------------------------------------------------------- the loss


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches_reference(dtype, masked):
    rng = np.random.RandomState(3)
    logits = (3.0 * rng.randn(3, 7, 257)).astype(np.float32)
    labels = rng.randint(0, 257, (3, 7)).astype(np.int32)
    mask = (rng.rand(3, 7) < 0.6).astype(np.float32) if masked else None
    r_logits = jnp.asarray(logits).astype(getattr(jnp, dtype))
    t_logits = torch.from_numpy(logits).to(getattr(torch, dtype))
    want = float(r_common.softmax_cross_entropy(
        r_logits, jnp.asarray(labels), None if mask is None else jnp.asarray(mask)))
    got = t_common.softmax_cross_entropy(
        t_logits, torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= CE_ATOL, (float(got), want)


def test_softmax_cross_entropy_empty_mask_is_zero():
    logits = torch.randn(2, 3, 11, generator=torch.Generator().manual_seed(0))
    labels = torch.zeros((2, 3), dtype=torch.int32)
    assert float(t_common.softmax_cross_entropy(logits, labels, torch.zeros(2, 3))) == 0.0


# ------------------------------------------------------- smoke loss + grads


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_forward_and_grad(arch):
    """The twin of ``tests/test_models.py::test_smoke_forward_and_grad``:
    the loss at init is finite and near ln(vocab), and every parameter
    gets a finite gradient."""
    cfg = t_configs.get_smoke_config(arch)
    mod = model_api.get_model(cfg)
    model = mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    loss, grads = _grads(cfg, model, _to_torch(_batch_np(cfg)))
    assert np.isfinite(loss)
    assert abs(loss - np.log(cfg.vocab)) < 2.5
    names = [n for n, _ in model.named_parameters()]
    assert sorted(grads) == sorted(names)
    for name, g in grads.items():
        assert g is not None and bool(torch.isfinite(g).all()), name


def test_serving_parameters_stay_frozen():
    """``init_params`` and the loaders make parameters without grad, as
    a server wants them; the trainer turns them on."""
    cfg = t_configs.get_smoke_config("qwen2-1.5b")
    model = model_api.get_model(cfg).init_params(cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits = model(torch.zeros((1, 4), dtype=torch.long))
    assert logits.grad_fn is None


# ------------------------------------------- per-family parity, f32, CPU


def _reference_pair(arch, batch):
    over = _overrides(arch)
    rcfg = r_configs.get_smoke_config(arch, **over)
    tcfg = t_configs.get_smoke_config(arch, **over)
    rmod = r_model_api.get_model(rcfg)
    params, _ = rmod.init_params(rcfg, jax.random.PRNGKey(0))
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: rmod.loss_fn(rcfg, p, rbatch)))(params)
    return tcfg, params, float(loss), grads


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_loss_and_grads_match_reference(arch):
    """Each family's loss within 1e-5 of the reference's ``loss_fn`` and
    every gradient within 1e-4 (relative L2) of ``jax.value_and_grad``'s,
    float32; the reference's gradients reach the port through the same
    loader as its parameters."""
    load = FAMILIES[arch]
    batch = _batch_np(t_configs.get_smoke_config(arch))
    tcfg, params, want_loss, want_grads = _reference_pair(arch, batch)
    model = load(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    loss, grads = _grads(tcfg, model, _to_torch(batch))
    assert abs(loss - want_loss) <= LOSS_ATOL, (loss, want_loss)
    ref = dict(load(jax.tree.map(np.asarray, want_grads), tcfg, device="cpu").named_parameters())
    assert sorted(ref) == sorted(grads)
    worst = {n: _rel_l2(grads[n].numpy(), ref[n].detach().numpy()) for n in grads}
    bad = {n: r for n, r in worst.items() if not r <= GRAD_RTOL}
    assert not bad, bad


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_remat_policies_give_the_same_gradients(policy):
    """Rematerialisation changes what is kept, not what is computed: the
    gradients of every policy equal remat off's bitwise (qwen2 smoke) and
    the forward under no_grad is untouched."""
    cfg = t_configs.get_smoke_config("qwen2-1.5b")
    batch = _to_torch(_batch_np(cfg))
    mod = model_api.get_model(cfg)
    base = mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, want = _grads(cfg, base, batch)
    other_cfg = t_configs.get_smoke_config("qwen2-1.5b", remat_policy=policy)
    other = mod.init_params(other_cfg, torch.Generator().manual_seed(0), device="cpu")
    _, got = _grads(other_cfg, other, batch)
    plain_cfg = t_configs.get_smoke_config("qwen2-1.5b", remat=False)
    plain = mod.init_params(plain_cfg, torch.Generator().manual_seed(0), device="cpu")
    _, off = _grads(plain_cfg, plain, batch)
    for n in want:
        assert torch.equal(got[n], off[n]), n
        assert torch.equal(want[n], off[n]), n


def test_unknown_remat_policy_raises():
    cfg = t_configs.get_smoke_config("qwen2-1.5b", remat_policy="sometimes")
    model = model_api.get_model(cfg).init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        model(torch.zeros((1, 4), dtype=torch.long))


def test_vlm_masks_patch_positions():
    """The twin of ``tests/test_models.py::test_vlm_masks_patch_positions``:
    the loss is the cross-entropy of the text positions only."""
    cfg = t_configs.get_smoke_config("internvl2-2b")
    mod = model_api.get_model(cfg)
    model = mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = _to_torch(_batch_np(cfg, S=16))
    loss = mod.loss_fn(cfg, model, b)
    assert np.isfinite(float(loss))
    logits = model(b)
    assert logits.shape[1] == cfg.n_patches + 16
    want = torch.nn.functional.cross_entropy(logits[:, cfg.n_patches:].reshape(-1, cfg.vocab),
                                             b["labels"].reshape(-1).long())
    assert abs(float(loss) - float(want)) <= 1e-5
    # changing the patches changes the loss only through the text positions
    b2 = {**b, "patches": b["patches"] + 1.0}
    assert float(mod.loss_fn(cfg, model, b2)) != float(loss)


# ------------------------------------------------------------ SSD backward


def test_ssd_kernel_route_backward_is_the_plain_route_bitwise():
    """On the CPU the kernel route's Function (plain forward, backward
    recomputed under autograd) gives autograd of ``ssd_chunked_ref``'s
    values and gradients bit for bit, L padded to the chunk."""
    rng = np.random.RandomState(0)
    Bb, L, H, P, G, N, chunk = 2, 40, 4, 8, 2, 16, 16
    x = rng.randn(Bb, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(Bb, L, H))).astype(np.float32) * 0.1
    A = -np.exp(rng.randn(H)).astype(np.float32)
    B = rng.randn(Bb, L, G, N).astype(np.float32)
    C = rng.randn(Bb, L, G, N).astype(np.float32)
    gy = torch.from_numpy(rng.randn(Bb, L, H, P).astype(np.float32))
    gS = torch.from_numpy(rng.randn(Bb, H, P, N).astype(np.float32))

    def run(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
        y, S = fn(*leaves)
        obj = (y * gy).sum() + (S * gS).sum()
        return y.detach(), S.detach(), torch.autograd.grad(obj, leaves)

    def plain(x, dt, A, B, C):
        xp, dtp, Bp, Cp = ssd_ops.pad_to_chunk(x, dt, B, C, chunk)
        y, S = ssd_ref.ssd_chunked_ref(xp, dtp, A, Bp, Cp, chunk=chunk)
        return y[:, :L], S

    y_k, S_k, g_k = run(lambda *a: ssd_ops.ssd(*a, chunk=chunk, impl="kernel"))
    y_p, S_p, g_p = run(plain)
    assert torch.equal(y_k, y_p) and torch.equal(S_k, S_p)
    for a, b in zip(g_k, g_p):
        assert torch.equal(a, b)


def test_ssd_kernel_route_output_has_a_graph():
    x = torch.randn(1, 16, 2, 4, requires_grad=True)
    dt = torch.rand(1, 16, 2)
    y, S = ssd_ops.ssd(x, dt, -torch.ones(2), torch.randn(1, 16, 1, 4), torch.randn(1, 16, 1, 4),
                       chunk=16, impl="kernel")
    assert y.grad_fn is not None and S.grad_fn is not None


# ------------------------------------------------------------ token stream


@pytest.mark.parametrize("step,shard", [(0, 0), (7, 3), (1234, 1), (9999, 2)])
def test_token_stream_pure_function(step, shard):
    """The twin of ``tests/test_data.py::test_token_stream_pure_function``."""
    cfg = t_tokens.TokenStreamConfig(vocab=128, seq_len=32)
    a = t_tokens.batch_at_step(cfg, step, 8, shard=shard, num_shards=4)
    b = t_tokens.batch_at_step(cfg, step, 8, shard=shard, num_shards=4)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert a["tokens"].shape == (2, 32)
    np.testing.assert_array_equal(a["labels"][:, :-1], b["tokens"][:, 1:])


def test_token_stream_has_learnable_structure():
    """The twin of ``tests/test_data.py::test_token_stream_has_learnable_structure``:
    an order-3 context beats the unigram entropy."""
    cfg = t_tokens.TokenStreamConfig(vocab=64, seq_len=256, rule_frac=0.8)
    batches = [t_tokens.batch_at_step(cfg, s, 16) for s in range(4)]
    toks = np.concatenate([b["tokens"].reshape(-1) for b in batches])
    p = np.bincount(toks, minlength=64) / len(toks)
    h1 = -np.sum(p[p > 0] * np.log(p[p > 0]))
    ctx = {}
    for row in np.concatenate([b["tokens"] for b in batches], 0):
        for t in range(3, len(row)):
            ctx.setdefault(tuple(row[t - 3 : t]), []).append(row[t])
    h3_num, n = 0.0, 0
    for nxt in ctx.values():
        if len(nxt) < 2:
            continue
        q = np.bincount(nxt, minlength=64) / len(nxt)
        h3_num += len(nxt) * -np.sum(q[q > 0] * np.log(q[q > 0]))
        n += len(nxt)
    assert h3_num / n < 0.7 * h1


@pytest.mark.parametrize(
    "kw", [dict(vocab=1024, seq_len=64), dict(vocab=151936, seq_len=33, seed=7),
           dict(vocab=50, seq_len=16, rule_order=2, rule_frac=0.9)],
    ids=["default", "qwen2-vocab", "order-2"],
)
@pytest.mark.parametrize("step,shard,num_shards", [(0, 0, 1), (5, 1, 2), (123456, 3, 4)])
def test_token_stream_bitwise_the_reference(kw, step, shard, num_shards):
    a = t_tokens.batch_at_step(t_tokens.TokenStreamConfig(**kw), step, 8, shard, num_shards)
    b = r_tokens.batch_at_step(r_tokens.TokenStreamConfig(**kw), step, 8, shard, num_shards)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------- the train step vs the reference


def _run_reference_steps(rcfg, params, tc_kw, steps):
    r_tc = r_train.TrainConfig(**tc_kw)
    r_opt = RAdamWConfig(lr=1e-3)
    from repro.optim import adamw_init, compression_init

    step_fn = jax.jit(r_train.make_step_fn(rcfg, r_opt, r_tc))
    opt = adamw_init(r_opt, params)
    err = compression_init(params) if r_tc.compress_grads else {}
    ds = r_tokens.TokenStreamConfig(vocab=rcfg.vocab, seq_len=r_tc.seq, seed=r_tc.seed)
    losses = []
    for step in range(steps):
        batch = {k: jnp.asarray(v) for k, v in r_tokens.batch_at_step(ds, step, r_tc.batch).items()}
        params, opt, err, metrics = step_fn(params, opt, err, batch, jnp.asarray(step))
        losses.append(float(metrics["loss"]))
    return params, losses


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_step_fn_tracks_reference(arch, n_micro, compress):
    """Four steps of the port's ``make_step_fn`` against the reference's,
    jitted, from the same parameters on the same batches: each step's
    loss within 1e-5, the parameters after 4 steps within 1e-4 (relative
    L2 over all of them; without compression, each one too).  With
    compression a gradient entry within rounding of a code boundary takes
    the other int8 code in one package, and AdamW, which moves a small
    gradient's entry by ~lr whatever its size, carries the flip into the
    small tensors (qwen2's k bias, whose exact gradient is zero, is
    rounding noise in both), so there only the whole is held."""
    tc_kw = dict(steps=4, batch=4, seq=16, n_micro=n_micro, compress_grads=compress)
    rcfg = r_configs.get_smoke_config(arch)
    tcfg = t_configs.get_smoke_config(arch)
    params, _ = r_model_api.get_model(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
    load = FAMILIES[arch]
    model = load(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    want_params, want_losses = _run_reference_steps(rcfg, params, tc_kw, 4)

    model.requires_grad_(True)
    tc = t_train.TrainConfig(**tc_kw)
    opt_cfg = AdamWConfig(lr=1e-3)
    from repro_torch.optim import adamw_init, compression_init

    ps = t_train.trainable(model)
    opt = adamw_init(opt_cfg, ps)
    err = compression_init(ps) if compress else {}
    step_fn = t_train.make_step_fn(tcfg, opt_cfg, tc)
    ds = t_tokens.TokenStreamConfig(vocab=tcfg.vocab, seq_len=tc.seq, seed=tc.seed)
    losses = []
    for step in range(4):
        batch = _to_torch(t_tokens.batch_at_step(ds, step, tc.batch))
        model, opt, err, metrics = step_fn(model, opt, err, batch, step)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_ATOL)
    assert int(opt["step"]) == 4
    ref = dict(load(jax.tree.map(np.asarray, want_params), tcfg, device="cpu").named_parameters())
    got = {n: p.detach().numpy() for n, p in t_train.trainable(model).items()}
    want = {n: ref[n].detach().numpy() for n in got}
    whole = _rel_l2(np.concatenate([g.ravel() for g in got.values()]),
                    np.concatenate([want[n].ravel() for n in got]))
    assert whole <= PARAM_RTOL, whole
    if not compress:
        bad = {n: r for n in got if not (r := _rel_l2(got[n], want[n])) <= PARAM_RTOL}
        assert not bad, bad


# ------------------------------------------------------ the loop and restarts


CFG_KW = dict(steps=12, batch=4, seq=16, save_every=4, async_ckpt=False)


def _final_params(arch, ckpt_dir, failure=None):
    cfg = t_configs.get_smoke_config(arch)
    tc = t_train.TrainConfig(**CFG_KW)

    def run():
        return t_train.train_loop(
            cfg, tc, ckpt_dir, opt_cfg=AdamWConfig(lr=1e-3),
            failure=failure, log=lambda *_: None, device="cpu",
        )

    return run_with_restarts(run)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_restart_bitwise_identical(arch, tmp_path):
    """The twin of ``tests/test_fault.py::test_restart_bitwise_identical``:
    training killed at steps 5 and 9 and restarted ends with exactly the
    parameters of an uninterrupted run."""
    clean = _final_params(arch, str(tmp_path / "clean"))
    inj = FailureInjector(fail_at_steps=(5, 9))
    faulty = _final_params(arch, str(tmp_path / "faulty"), inj)
    assert clean["steps_done"] == faulty["steps_done"] == 12
    assert clean["loss"] == faulty["loss"]
    assert clean["params"].keys() == faulty["params"].keys()
    for n in clean["params"]:
        assert torch.equal(clean["params"][n], faulty["params"][n]), n


def test_train_loop_matches_step_fn_and_lowers_loss(tmp_path):
    """``train_loop`` (async saves) is ``make_step_fn`` over the token
    stream from ``init_params(seed)``; its loss falls over 12 steps."""
    cfg = t_configs.get_smoke_config("qwen2-1.5b")
    tc = t_train.TrainConfig(steps=12, batch=4, seq=16, save_every=5)
    logs = []
    out = t_train.train_loop(cfg, tc, str(tmp_path), opt_cfg=AdamWConfig(lr=1e-3),
                             log=logs.append, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["step_10", "step_12", "step_5"]
    losses = [float(line.split("loss ")[1].split()[0]) for line in logs]
    assert len(losses) == 3 and losses[-1] < losses[0]

    model = model_api.get_model(cfg).init_params(
        cfg, torch.Generator("cpu").manual_seed(tc.seed), device="cpu")
    model.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=1e-3)
    from repro_torch.optim import adamw_init

    opt = adamw_init(opt_cfg, t_train.trainable(model))
    step_fn = t_train.make_step_fn(cfg, opt_cfg, tc)
    ds = t_tokens.TokenStreamConfig(vocab=cfg.vocab, seq_len=tc.seq, seed=tc.seed)
    for step in range(tc.steps):
        batch = _to_torch(t_tokens.batch_at_step(ds, step, tc.batch))
        model, opt, _, metrics = step_fn(model, opt, {}, batch, step)
    assert float(metrics["loss"]) == out["loss"]
    for n, p in t_train.trainable(model).items():
        assert torch.equal(p, out["params"][n]), n


def test_train_loop_on_a_larger_mesh_raises(tmp_path):
    cfg = t_configs.get_smoke_config("qwen2-1.5b")
    mesh = t_mesh.make_local_mesh(1, 2, devices=("cpu",) * 2)
    with pytest.raises(NotImplementedError, match="A.7b"):
        t_train.train_loop(cfg, t_train.TrainConfig(steps=1), str(tmp_path), mesh=mesh, device="cpu")
    assert not os.path.exists(tmp_path / "step_1")


def test_train_loop_on_a_one_device_mesh(tmp_path):
    cfg = t_configs.get_smoke_config("mamba2-370m")
    mesh = t_mesh.make_local_mesh(1, 1, devices=("cpu",))
    tc = t_train.TrainConfig(steps=2, batch=2, seq=16, async_ckpt=False)
    out = t_train.train_loop(cfg, tc, str(tmp_path), mesh=mesh, log=lambda *_: None)
    assert out["steps_done"] == 2 and np.isfinite(out["loss"])
    assert all(p.device.type == "cpu" for p in out["params"].values())


def test_example_resumes_from_its_checkpoint(tmp_path):
    """``examples/lm_train_torch.py --device cpu`` twice: the second run
    resumes from the first's checkpoint."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, os.path.join(ROOT, "examples", "lm_train_torch.py"),
           "--arch", "mamba2-370m", "--batch", "2", "--seq", "16",
           "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = subprocess.run(cmd + ["--steps", "5"], capture_output=True, text=True, env=env,
                           timeout=300)
    assert first.returncode == 0, first.stderr
    assert "resumed" not in first.stdout and "after 5 steps" in first.stdout
    second = subprocess.run(cmd + ["--steps", "8"], capture_output=True, text=True, env=env,
                            timeout=300)
    assert second.returncode == 0, second.stderr
    assert "[train] resumed from step 5" in second.stdout
    assert "after 8 steps" in second.stdout
