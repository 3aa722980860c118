"""Training on a mesh in the port (``launch.train.mesh_step``, the
``activate`` / ``constrain`` twins in ``distributed.sharding``) against
the one-device step and the JAX reference, on smoke configs in float32
on the CPU.

* ``constrain`` returns its input; ``activate`` nests and is per thread.
* The mesh knob ``seq_shard`` constrains at the reference's sites, per
  call, for the dense and VLM families.
* Every family names the reference's constraints: the (shape, logical
  axes, spec) of every ``constrain`` call in one ``loss_fn`` on a (2, 2)
  mesh, counted per call, equal the reference's, recorded by patching the
  ``constrain`` that each ``repro.models`` module imported, and traced
  with ``lax.scan`` unrolled (so a scan calls its body once per layer)
  and ``remat`` off (``jax.checkpoint`` traces a layer once and reuses
  the trace for the next of the same shapes).
* The mesh step on (2, 2), (1, 4) and (4, 2) logical CPU meshes against
  the one-device step with ``data × n_micro`` microbatches (the same
  rows in each microbatch): the loss within 1e-6 relative, every
  parameter, ``m`` and ``v`` within 1e-5 relative L2 after two steps,
  every tile its index of the whole tensor; on (1, 4) (one data rank)
  the gradients bitwise, with and without ``grad_shardings``.
* The reference's own sharded step (the twin of
  ``tests/test_sharding.py``'s ``PJIT_SCRIPT``: granite-8b smoke, a (4,
  2) mesh of forced host devices, ``n_micro=2``, 8 rows so that the data
  ranks and microbatches divide them) in one subprocess, against the
  port's (4, 2) step from the same parameters.
* ``train_loop`` on a (2, 2) mesh: restarts bitwise, its checkpoint and
  a one-device one interchangeable, its parameters the one-device run's.
"""

import collections
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.mamba2  # noqa: E402
import repro.models.mla  # noqa: E402
import repro.models.moe  # noqa: E402
import repro.models.transformer  # noqa: E402
import repro.models.vlm  # noqa: E402
import repro.models.whisper  # noqa: E402
import repro.models.zamba  # noqa: E402
from repro import configs as r_configs  # noqa: E402
from repro.distributed import sharding as r_shd  # noqa: E402
from repro.models import model_api as r_model_api  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import checkpoint as t_ckpt  # noqa: E402
from repro_torch.data import tokens as t_tokens  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.fault import FailureInjector, run_with_restarts  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import model_api  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, compression_init  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADERS = {
    "qwen2-1.5b": interop.transformer_params_from_numpy,
    "mamba2-370m": interop.mamba2_params_from_numpy,
    "zamba2-2.7b": interop.zamba_params_from_numpy,
    "arctic-480b": interop.moe_params_from_numpy,
    "deepseek-v2-lite-16b": interop.mla_params_from_numpy,
    "whisper-tiny": interop.whisper_params_from_numpy,
    "internvl2-2b": interop.vlm_params_from_numpy,
}
# every module of the reference whose code calls the ``constrain`` it imported
R_MODULES = [repro.models.transformer, repro.models.mamba2, repro.models.moe, repro.models.mla,
             repro.models.zamba, repro.models.whisper, repro.models.vlm]
LOSS_RTOL = 1e-6  # relative, mesh step against the one-device step
STATE_RTOL = 1e-5  # relative L2 per tensor after two steps
REF_LOSS_ATOL = 1e-3  # the reference test's own bound (tests/test_sharding.py)
REF_PARAM_RTOL = 1e-4  # relative L2 per parameter after one step (as test_torch_lm_train.PARAM_RTOL)


def _mesh(data, model):
    return make_local_mesh(data, model, devices=("cpu",) * (data * model))


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    diff = np.linalg.norm(got - want)
    return float(diff / norm) if norm > 0 else float(diff)


def _model(cfg, seed=0):
    model = model_api.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    model.requires_grad_(True)
    return model


def _token_batch(cfg, step, rows, seq=16) -> dict:
    ds = t_tokens.TokenStreamConfig(vocab=cfg.vocab, seq_len=seq, seed=0)
    return {k: torch.from_numpy(v) for k, v in t_tokens.batch_at_step(ds, step, rows).items()}


# ----------------------------------------------------- activate / constrain


def test_constrain_returns_its_input_inside_and_outside_activate():
    x = torch.randn(4, 6, 8)
    assert shd.constrain(x, ("batch", None, "mlp")) is x
    with shd.activate(_mesh(2, 2), shd.make_rules("train")), shd.record_constraints() as rec:
        assert shd.constrain(x, ("batch", None, "mlp")) is x
    assert rec == [((4, 6, 8), torch.float32, ("batch", None, "mlp"), ("data", None, "model"))]


def test_activate_nests_and_restores_the_outer_mesh():
    x = torch.zeros(4, 6)  # 6 splits over a model axis of 2, not of 4
    rules = shd.make_rules("train")
    with shd.record_constraints() as rec:
        shd.constrain(x, ("batch", "mlp"))  # outside: nothing resolved
        with shd.activate(_mesh(2, 2), rules):
            shd.constrain(x, ("batch", "mlp"))
            with shd.activate(_mesh(1, 4), rules):
                shd.constrain(x, ("batch", "mlp"))
            shd.constrain(x, ("batch", "mlp"))
        shd.constrain(x, ("batch", "mlp"))
    assert [r[3] for r in rec] == [("data", "model"), ("data", None), ("data", "model")]


def test_another_thread_sees_no_active_mesh():
    seen = {}

    def other():
        with shd.record_constraints() as rec:
            seen["same"] = shd.constrain(x, ("batch", None)) is x
        seen["rec"] = rec

    x = torch.zeros(4, 8)
    with shd.activate(_mesh(2, 2), shd.make_rules("train")), shd.record_constraints() as mine:
        t = threading.Thread(target=other)
        t.start()
        t.join()
        shd.constrain(x, ("batch", None))
    assert seen == {"same": True, "rec": []}
    assert len(mine) == 1


# ------------------------------------------------------------------- sites


class _FakeMesh:
    shape = {"data": 2, "model": 2}


def _site_batch(cfg, B=2, S=16) -> dict:
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.randn(B, cfg.n_frames, cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(B, cfg.n_patches, cfg.d_model).astype(np.float32)
    return batch


def _unrolled_scan(f, init, xs=None, length=None, reverse=False, **_):
    """``lax.scan`` as a Python loop: the body is called once per step."""
    n = length if xs is None else jax.tree.leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in (reversed(range(n)) if reverse else range(n)):
        carry, y = f(carry, None if xs is None else jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    if reverse:
        ys.reverse()
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def _reference_sites(arch, batch, **knobs) -> tuple[collections.Counter, dict]:
    """The reference's (shape, axes, spec) per ``constrain`` call over one
    trace of ``loss_fn`` without remat and with ``lax.scan`` unrolled, and
    its parameters (numpy), ``constrain`` patched in every model module;
    ``knobs`` override the smoke config."""
    rcfg = r_configs.get_smoke_config(arch, remat=False, **knobs)
    rmod = r_model_api.get_model(rcfg)
    params, _ = rmod.init_params(rcfg, jax.random.PRNGKey(0))
    rules = r_shd.make_rules("train")
    calls = collections.Counter()

    def record(x, axes):
        axes = tuple(axes)
        calls[(tuple(x.shape), axes, tuple(r_shd.spec_for(x.shape, axes, rules, _FakeMesh())))] += 1
        return x

    saved = [m.constrain for m in R_MODULES], jax.lax.scan
    try:
        for m in R_MODULES:
            m.constrain = record
        jax.lax.scan = _unrolled_scan
        jax.make_jaxpr(lambda p, b: rmod.loss_fn(rcfg, p, b))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        for m, c in zip(R_MODULES, saved[0]):
            m.constrain = c
        jax.lax.scan = saved[1]
    return calls, jax.tree.map(np.asarray, params)


def _port_sites(arch, params, batch, **knobs) -> collections.Counter:
    cfg = t_configs.get_smoke_config(arch, **knobs)
    model = LOADERS[arch](params, cfg, device="cpu")
    with shd.activate(_mesh(2, 2), shd.make_rules("train")), shd.record_constraints() as rec:
        model_api.get_model(cfg).loss_fn(cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    return collections.Counter((shape, axes, tuple(spec)) for shape, _, axes, spec in rec)


@pytest.mark.parametrize("arch", list(LOADERS))
def test_every_family_constrains_at_the_references_sites(arch):
    """One ``constrain`` call in the port for each of the reference's: the
    multisets of (shape, axes, spec) of one forward ``loss_fn`` agree (a
    missing or doubled site differs in its count)."""
    batch = _site_batch(t_configs.get_smoke_config(arch))
    want, params = _reference_sites(arch, batch)
    got = _port_sites(arch, params, batch)
    assert want and got == want, (sorted((want - got).items(), key=str), sorted((got - want).items(), key=str))


# the reference's mesh knobs that the port's config carries, as the dry
# run's variant keys set them
KNOBS = {
    "seqshard": {"seq_shard": True},
}


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internvl2-2b"])
def test_mesh_knobs_constrain_at_the_references_sites(arch, knob):
    """Under each mesh knob the dense and VLM families' ``constrain``
    calls are the reference's, per call: the residual sequence-sharded
    between layers (``seq_shard``)."""
    knobs = KNOBS[knob]
    batch = _site_batch(t_configs.get_smoke_config(arch))
    want, params = _reference_sites(arch, batch, **knobs)
    got = _port_sites(arch, params, batch, **knobs)
    assert want and got == want, (sorted((want - got).items(), key=str), sorted((got - want).items(), key=str))
    plain, _ = _reference_sites(arch, batch)
    assert want != plain  # the knob placed constraints of its own


# ----------------------------------------------- the step against one device


def _run_pair(arch, mesh_shape, n_micro=2, rows=8, steps=2, compress=False):
    """``steps`` of the one-device step (data × n_micro microbatches) and
    of the mesh step from the same model: (one-device model, opt, mesh
    ShardedModel, its opt, losses of each)."""
    cfg = t_configs.get_smoke_config(arch)
    opt_cfg = AdamWConfig(lr=1e-3)
    data = mesh_shape[0]
    one = t_train.TrainConfig(steps=steps, batch=rows, seq=16, n_micro=data * n_micro,
                              compress_grads=compress)
    on_mesh = t_train.TrainConfig(steps=steps, batch=rows, seq=16, n_micro=n_micro,
                                  compress_grads=compress)
    m1 = _model(cfg)
    o1 = adamw_init(opt_cfg, t_train.trainable(m1))
    e1 = compression_init(t_train.trainable(m1)) if compress else {}
    m2 = _model(cfg)
    p2 = t_train.trainable(m2)
    sm, o2, e2 = t_train.to_mesh(cfg, m2, adamw_init(opt_cfg, p2),
                                 compression_init(p2) if compress else {}, _mesh(*mesh_shape))
    f1 = t_train.make_step_fn(cfg, opt_cfg, one)
    f2 = t_train.make_step_fn(cfg, opt_cfg, on_mesh)
    l1, l2 = [], []
    for step in range(steps):
        batch = _token_batch(cfg, step, rows)
        _, o1, e1, met1 = f1(m1, o1, e1, batch, step)
        _, o2, e2, met2 = f2(sm, o2, e2, batch, step)
        l1.append(float(met1["loss"]))
        l2.append(float(met2["loss"]))
    return m1, o1, sm, o2, l1, l2


def _check_tiles(held: shd.ShardedTensor) -> None:
    whole = held.full("cpu")
    for pos in held.sharding.positions():
        assert torch.equal(held.shard(*pos), whole[held.index(*pos)]), pos


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 2)], ids=["2x2", "1x4", "4x2"])
@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-370m"])
def test_mesh_step_tracks_the_one_device_step(arch, mesh_shape):
    m1, o1, sm, o2, l1, l2 = _run_pair(arch, mesh_shape)
    for a, b in zip(l1, l2):
        assert abs(a - b) <= LOSS_RTOL * abs(a), (l1, l2)
    assert int(o1["step"]) == int(o2["step"]) == 2
    bad = {}
    for name, p in t_train.trainable(m1).items():
        for tag, want, held in (("p", p, sm.params[name]), ("m", o1["m"][name], o2["m"][name]),
                                ("v", o1["v"][name], o2["v"][name])):
            _check_tiles(held)
            err = _rel_l2(held.full("cpu").numpy(), want.detach().numpy())
            if not err <= STATE_RTOL:
                bad[f"{tag} {name}"] = err
    assert not bad, bad
    # the compute module holds the tiles' values after the step
    for name, p in t_train.trainable(sm.module()).items():
        assert torch.equal(p.detach(), sm.params[name].full("cpu")), name


def test_mesh_step_with_compression_tracks_the_one_device_step():
    m1, _, sm, o2, l1, l2 = _run_pair("granite-8b", (2, 2), compress=True)
    for a, b in zip(l1, l2):
        assert abs(a - b) <= LOSS_RTOL * abs(a), (l1, l2)
    for name, p in t_train.trainable(m1).items():
        _check_tiles(sm.params[name])
        assert _rel_l2(sm.params[name].full("cpu").numpy(), p.detach().numpy()) <= STATE_RTOL, name


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-370m"])
def test_one_data_rank_gives_the_one_device_gradients_bitwise(arch):
    """On (1, 4) the gradients' tiles are the one-device gradients' slices
    bitwise, with and without ``grad_shardings``, and so is the loss."""
    cfg = t_configs.get_smoke_config(arch)
    model = _model(cfg)
    batch = _token_batch(cfg, 0, 8)
    loss1, grads1 = t_train.loss_and_grads(cfg, model, batch, 2)
    sm, _, _ = t_train.to_mesh(cfg, model, adamw_init(AdamWConfig(), t_train.trainable(model)), {},
                               _mesh(1, 4))
    loss2, grads2 = t_train.sharded_grads(cfg, sm, batch, 2)
    gs = {n: p.sharding for n, p in sm.params.items()}
    loss3, grads3 = t_train.sharded_grads(cfg, sm, batch, 2, grad_shardings=gs)
    assert torch.equal(loss1, loss2) and torch.equal(loss2, loss3)
    for name, g in grads1.items():
        for pos in gs[name].positions():
            assert torch.equal(grads2[name].shard(*pos), g[gs[name].index(g.shape, *pos)]), name
            assert torch.equal(grads3[name].shard(*pos), grads2[name].shard(*pos)), name


def test_grad_norm_counts_a_replicated_tile_once():
    """On (2, 2) the 1-D norm weights are held four times; the step's
    grad_norm is still the one-device norm of the gradients."""
    cfg = t_configs.get_smoke_config("mamba2-370m")
    model = _model(cfg)
    sm, opt, _ = t_train.to_mesh(cfg, model, adamw_init(AdamWConfig(), t_train.trainable(model)), {},
                                 _mesh(2, 2))
    assert sm.params["final_norm"].nbytes == 4 * sm.params["final_norm"].shard(0, 0).nbytes
    batch = _token_batch(cfg, 0, 8)
    _, grads = t_train.sharded_grads(cfg, sm, batch, 2)
    metrics = t_train.sharded_adamw(AdamWConfig(), sm.params, grads, opt)
    _, whole = t_train.loss_and_grads(cfg, _model(cfg), batch, 4)
    want = float(torch.sqrt(sum(torch.sum(torch.square(g)) for g in whole.values())))
    assert abs(float(metrics["grad_norm"]) - want) <= 1e-6 * want


@pytest.mark.parametrize("layout", ["params", "replicated"])
def test_make_train_step_with_grad_shardings_runs_the_mesh_step(layout):
    """``specs.make_train_step(grad_shardings=...)`` on (1, 4): the same
    step as without it, bitwise (one data rank), whether the accumulator
    is laid out like the parameters or replicated (then re-cut onto the
    parameters' layout for the tile update)."""
    cfg = t_configs.get_smoke_config("granite-8b")
    opt_cfg = AdamWConfig(lr=1e-3)
    batch = _token_batch(cfg, 0, 8)
    out = []
    for with_gs in (False, True):
        model = _model(cfg)
        sm, opt, _ = t_train.to_mesh(cfg, model, adamw_init(opt_cfg, t_train.trainable(model)), {},
                                     _mesh(1, 4))
        gs = None
        if with_gs:
            gs = {n: p.sharding if layout == "params" else
                  shd.NamedSharding(p.sharding.mesh, shd.PartitionSpec(*(None,) * len(p.shape)))
                  for n, p in sm.params.items()}
        sm, opt, metrics = t_specs.make_train_step(cfg, opt_cfg, n_micro=2, grad_shardings=gs)(sm, opt, batch)
        out.append((metrics, {n: p.full("cpu") for n, p in sm.params.items()}))
    (m_a, p_a), (m_b, p_b) = out
    assert torch.equal(m_a["loss"], m_b["loss"]) and torch.equal(m_a["grad_norm"], m_b["grad_norm"])
    for name in p_a:
        assert torch.equal(p_a[name], p_b[name]), name


def test_grad_shardings_leaf_errors_name_the_leaf():
    cfg = t_configs.get_smoke_config("granite-8b")
    names = list(t_specs.params_specs(cfg))
    full = {n: shd.NamedSharding(_mesh(1, 4), shd.PartitionSpec(*(None,) * s.dim()))
            for n, s in t_specs.params_specs(cfg).items()}
    with pytest.raises(ValueError, match="lm_head"):
        t_specs.make_train_step(cfg, AdamWConfig(), grad_shardings={**full, "lm_head": "model"})
    last = names[-1]
    other = shd.NamedSharding(_mesh(2, 2), full[last].spec)
    with pytest.raises(ValueError, match=last.replace(".", r"\.") + ".*another mesh"):
        t_specs.make_train_step(cfg, AdamWConfig(), grad_shardings={**full, last: other})


def test_a_batch_the_data_ranks_do_not_divide_raises():
    cfg = t_configs.get_smoke_config("granite-8b")
    model = _model(cfg)
    sm, opt, _ = t_train.to_mesh(cfg, model, adamw_init(AdamWConfig(), t_train.trainable(model)), {},
                                 _mesh(2, 2))
    with pytest.raises(ValueError, match=r"6 rows .*data"):
        t_train.mesh_step(cfg, AdamWConfig(), sm, opt, {}, _token_batch(cfg, 0, 6), n_micro=2)
    assert int(opt["step"]) == 0


# ------------------------------------------------------ against the reference


REFERENCE_STEP_SCRIPT = r"""
import os, sys
# eight host devices on one compute thread: the suite runs workers side by side
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
import jax, numpy as np
import jax.numpy as jnp
# the reference's meshes were written for automatic axes (jax.make_mesh's
# default up to the jax that CI pins); where the default is explicit axes
# its constrain refuses the specs, so its mesh is built as written for
if hasattr(jax.sharding, "AxisType"):
    _make_mesh = jax.make_mesh
    jax.make_mesh = lambda shape, axes, **kw: _make_mesh(
        shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes), **kw)
from repro import configs
from repro.distributed import sharding as shd
from repro.launch import mesh as mesh_lib
from repro.launch import specs
from repro.models import model_api
from repro.optim import AdamWConfig, adamw_init

cfg = configs.get_smoke_config("granite-8b")
mod = model_api.get_model(cfg)
mesh = mesh_lib.make_local_mesh(4, 2)
rules = shd.make_rules("train")
params, axes = mod.init_params(cfg, jax.random.PRNGKey(0))
p_sh = shd.tree_shardings(params, axes, rules, mesh)
params = jax.tree.map(lambda a, s: jax.device_put(a, s), params, p_sh)
opt_cfg = AdamWConfig(lr=1e-3)
opt = adamw_init(opt_cfg, params)
step = specs.make_train_step(cfg, opt_cfg, n_micro=2)
toks = jnp.arange(8 * 16, dtype=jnp.int32).reshape(8, 16) % cfg.vocab
batch = {"tokens": toks, "labels": toks}
with mesh, shd.activate(mesh, rules):
    p2, o2, m = jax.jit(step, donate_argnums=(0, 1))(params, opt, batch)
leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(p2)]
np.savez(sys.argv[1], loss=np.asarray(m["loss"]), grad_norm=np.asarray(m["grad_norm"]),
         **{f"leaf{i}": x for i, x in enumerate(leaves)})
print("REFERENCE_STEP_OK", len(jax.devices()))
"""


def test_mesh_step_matches_the_references_sharded_step(tmp_path):
    """The reference's jitted step on its (4, 2) mesh of eight forced host
    devices (a subprocess) against the port's (4, 2) step from the same
    parameters on the same batch: the loss within the reference test's
    1e-3 (it lands within 1e-6), the global norm within 1e-5 relative,
    and every updated parameter within 1e-4 relative L2 (one near-zero
    embedding gradient entry rounds apart, as it does in the port's
    one-device step)."""
    path = str(tmp_path / "ref_step.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", REFERENCE_STEP_SCRIPT, path], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600)
    assert "REFERENCE_STEP_OK 8" in proc.stdout, proc.stderr[-3000:]
    rcfg = r_configs.get_smoke_config("granite-8b")
    params, _ = r_model_api.get_model(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    with np.load(path) as z:
        ref_loss, ref_norm = float(z["loss"]), float(z["grad_norm"])
        updated = jax.tree_util.tree_unflatten(treedef, [z[f"leaf{i}"] for i in range(len(leaves))])
    cfg = t_configs.get_smoke_config("granite-8b")
    opt_cfg = AdamWConfig(lr=1e-3)
    model = interop.transformer_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    model.requires_grad_(True)
    sm, opt, _ = t_train.to_mesh(cfg, model, adamw_init(opt_cfg, t_train.trainable(model)), {},
                                 _mesh(4, 2))
    toks = (torch.arange(8 * 16, dtype=torch.int32).reshape(8, 16) % cfg.vocab)
    sm, opt, metrics = t_specs.make_train_step(cfg, opt_cfg, n_micro=2)(
        sm, opt, {"tokens": toks, "labels": toks})
    assert abs(float(metrics["loss"]) - ref_loss) <= REF_LOSS_ATOL, (float(metrics["loss"]), ref_loss)
    assert abs(float(metrics["loss"]) - ref_loss) <= 1e-6 * ref_loss
    assert abs(float(metrics["grad_norm"]) - ref_norm) <= 1e-5 * ref_norm
    want = dict(interop.transformer_params_from_numpy(updated, cfg, device="cpu").named_parameters())
    bad = {n: e for n, p in sm.params.items()
           if not (e := _rel_l2(p.full("cpu").numpy(), want[n].detach().numpy())) <= REF_PARAM_RTOL}
    assert not bad, bad


# ------------------------------------------------------------ train_loop


LOOP_KW = dict(steps=4, batch=4, seq=16, save_every=2, async_ckpt=False)


def _loop(arch, ckpt_dir, mesh, steps=4, failure=None, **kw):
    cfg = t_configs.get_smoke_config(arch)
    tc = t_train.TrainConfig(**{**LOOP_KW, "steps": steps, **kw})
    logs = []

    def run():
        return t_train.train_loop(cfg, tc, str(ckpt_dir), opt_cfg=AdamWConfig(lr=1e-3),
                                  failure=failure, mesh=mesh, log=logs.append, device="cpu")

    return run_with_restarts(run), logs


def test_train_loop_on_a_mesh_restarts_bitwise(tmp_path):
    """A (2, 2) run killed at step 2 and resumed (from its own mesh
    checkpoint) ends bitwise equal to an uninterrupted (2, 2) run."""
    clean, _ = _loop("mamba2-370m", tmp_path / "clean", _mesh(2, 2))
    faulty, logs = _loop("mamba2-370m", tmp_path / "faulty", _mesh(2, 2),
                         failure=FailureInjector(fail_at_steps=(2,)))
    assert "[train] resumed from step 2" in logs
    assert clean["steps_done"] == faulty["steps_done"] == 4 and clean["loss"] == faulty["loss"]
    for n, p in clean["params"].items():
        assert torch.equal(p, faulty["params"][n]), n


def test_train_loop_checkpoints_move_between_a_mesh_and_one_device(tmp_path):
    """A (2, 2) run's checkpoint holds whole leaves that restore on one
    device bitwise and resume there; a one-device checkpoint resumes on
    the mesh; each run ends within the float32 bound of the one-device
    run (4 steps, the same batches)."""
    one, _ = _loop("granite-8b", tmp_path / "one", None)
    mesh_run, _ = _loop("granite-8b", tmp_path / "mesh", _mesh(2, 2), steps=2)
    cfg = t_configs.get_smoke_config("granite-8b")
    templates = {"params": t_train.trainable(_model(cfg))}
    host = t_ckpt.restore(str(tmp_path / "mesh"), 2, templates)
    for n, p in mesh_run["params"].items():
        assert torch.equal(host["params"][n], p), n
    to_one, logs_a = _loop("granite-8b", tmp_path / "mesh", None)  # mesh ckpt → one device
    _loop("granite-8b", tmp_path / "half", None, steps=2)
    to_mesh, logs_b = _loop("granite-8b", tmp_path / "half", _mesh(2, 2))  # one-device ckpt → mesh
    assert "[train] resumed from step 2" in logs_a and "[train] resumed from step 2" in logs_b
    full_mesh, _ = _loop("granite-8b", tmp_path / "mesh_full", _mesh(2, 2))
    for run in (to_one, to_mesh, full_mesh):
        for n, p in one["params"].items():
            assert _rel_l2(run["params"][n].detach().numpy(), p.detach().numpy()) <= STATE_RTOL, n
