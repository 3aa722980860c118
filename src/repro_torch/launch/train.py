"""Fault-tolerant LM training loop on one device (port of
``repro.launch.train``).

Wires the substrates together: model zoo → train step (gradient
accumulation over ``n_micro`` microbatches in float32, optional int8
gradient compression with error feedback) → AdamW → atomic checkpoints →
auto-resume.  The model is an ``nn.Module`` whose parameters this loop
turns trainable (``requires_grad_``); the step writes the new values into
them, and into the optimizer state, in place.

Restart contract (the reference's): the batches are a pure function of
the step (``data.tokens.batch_at_step``) and a checkpoint holds the
parameters, both moments, the step count and the error-feedback state,
so a run killed and resumed by ``distributed.fault.run_with_restarts``
ends with final parameters bitwise equal to an uninterrupted run's.

On a mesh (a ``LocalMesh`` larger than 1 × 1) the step is explicit
SPMD, the port's counterpart of the reference's step under ``jax.jit``
with ``NamedSharding``'d state (:func:`mesh_step`, the one executor of
``train_loop(mesh=...)`` and ``specs.make_train_step(grad_shardings=...)``):

* the parameters, AdamW's ``m`` and ``v`` and the error-feedback state
  are ``ShardedTensor``s laid out by ``tree_shardings`` of the family's
  logical axes under ``make_rules("train")`` (a :class:`ShardedModel`
  holds the parameters beside one compute module per distinct device);
* a step all-gathers every parameter into the compute module, runs
  :func:`loss_and_grads` on each data rank's rows of the batch in rank
  order, and reduce-scatters the ranks' mean gradients (float32, summed
  in rank order) into tiles laid out like their parameters; with
  ``compress_grads`` each reduced gradient is quantized whole, then cut;
* AdamW updates each position's own tiles (:func:`sharded_adamw`; the
  global norm counts each distinct tile once), and the compute module
  is refreshed from them.

The ``model`` axis shards storage only (parameters, gradients, moments):
no matmul is split over it, so a step's values are the one-device step's
up to the order of the reductions.  The loop runs under
``sharding.activate(mesh, rules)`` as the reference's does, and saves
every leaf whole, in the one-device layout: a checkpoint written on any
mesh restores on any other (``checkpoint.restore_resharded``).

CLI (smoke scale; ``--device cpu`` on a host without a card):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.data import tokens as token_data
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault import FailureInjector
from repro_torch.models import model_api
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    compress_gradients,
    compression_init,
    cosine_schedule,
)
from repro_torch.optim import adamw as adamw_lib

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass
class TrainConfig:
    steps: int = 50
    batch: int = 8
    seq: int = 64
    n_micro: int = 1
    save_every: int = 10
    keep: int = 3
    compress_grads: bool = False
    lr_total_steps: int | None = None
    warmup: int = 5
    seed: int = 1234
    async_ckpt: bool = True


def trainable(model: torch.nn.Module) -> dict[str, Tensor]:
    """The parameters that require grad, by name (the optimizer's and the
    checkpoint's tree)."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _microbatch(batch: dict, n_micro: int, i: int) -> dict:
    """The i-th of ``n_micro`` consecutive row slices of every tensor."""
    return {k: x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])[i] for k, x in batch.items()}


def loss_and_grads(
    cfg, model: torch.nn.Module, batch: dict, n_micro: int = 1,
    acc_dtype: torch.dtype = torch.float32,
) -> tuple[Tensor, dict[str, Tensor]]:
    """The family's ``loss_fn`` on ``batch`` and its gradients for every
    trainable parameter, by name.  With ``n_micro`` > 1 the batch is split
    along its first dim into that many consecutive microbatches, each
    microbatch's gradients cast to ``acc_dtype`` and summed, and the loss
    and the sum divided by ``n_micro`` (the reference's scan)."""
    mod = model_api.get_model(cfg)
    params = trainable(model)
    names, leaves = list(params), list(params.values())
    if n_micro == 1:
        loss = mod.loss_fn(cfg, model, batch)
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows does not split into {n_micro}")
    acc = {n: torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for n, p in params.items()}
    loss_sum = 0.0
    for i in range(n_micro):
        loss = mod.loss_fn(cfg, model, _microbatch(batch, n_micro, i))
        for name, g in zip(names, torch.autograd.grad(loss, leaves)):
            acc[name].add_(g.to(acc_dtype))
        loss_sum = loss_sum + loss.detach()
    return loss_sum / n_micro, {n: g / n_micro for n, g in acc.items()}


# ---------------------------------------------------------------------------
# the step on a mesh
# ---------------------------------------------------------------------------


class ShardedModel:
    """A model's trainable parameters laid out on a mesh: ``params`` maps
    each name to a :class:`~repro_torch.distributed.sharding.ShardedTensor`
    (the FSDP storage), and ``modules`` maps each distinct device of the
    mesh to a compute module there, whose trainable parameters a step
    fills by ``sharding.all_gather`` before it computes.  ``model`` (the
    module the state came from) is the compute module of its device."""

    def __init__(self, model: torch.nn.Module, params: dict, mesh, rules: shd.Rules):
        self.mesh, self.rules, self.params = mesh, rules, params
        self.modules = {}
        for row in mesh.devices:
            for dev in row:
                if dev not in self.modules:
                    same = next(iter(model.parameters())).device == dev
                    self.modules[dev] = model if same else copy.deepcopy(model).to(dev)

    def module(self, device=None) -> torch.nn.Module:
        """The compute module on ``device`` (default: the mesh's first)."""
        return self.modules[torch.device(device) if device is not None else self.mesh.device(0, 0)]


def state_shardings(cfg, trees: dict, mesh, rules: shd.Rules) -> dict:
    """``NamedSharding`` trees for training state ``{"params", "opt",
    "err"}`` (as ``restore_resharded`` takes them): the family's logical
    axes (``specs.params_logical_axes``) for the parameters and the
    error feedback, ``specs.opt_logical_axes`` of them for AdamW."""
    from repro_torch.launch import specs

    axes = specs.params_logical_axes(cfg)
    return {
        "params": shd.tree_shardings(trees["params"], axes, rules, mesh),
        "opt": shd.tree_shardings(trees["opt"], specs.opt_logical_axes(axes), rules, mesh),
        "err": shd.tree_shardings(trees["err"], {n: axes[n] for n in trees["err"]}, rules, mesh),
    }


def _cut(tree, shardings):
    if isinstance(tree, dict):
        return {k: _cut(v, shardings[k]) for k, v in tree.items()}
    return shd.ShardedTensor.from_full(tree, shardings)


def from_sharded_state(model: torch.nn.Module, state: dict, mesh, rules: shd.Rules):
    """(ShardedModel, opt_state, err_state) from sharded training state
    ``{"params", "opt", "err"}`` (``restore_resharded``'s tree): the
    step count becomes one tensor on the mesh's first device."""
    opt = dict(state["opt"])
    if isinstance(opt["step"], shd.ShardedTensor):
        opt["step"] = opt["step"].full(mesh.device(0, 0))
    return ShardedModel(model, state["params"], mesh, rules), opt, state["err"]


def to_mesh(cfg, model: torch.nn.Module, opt_state: dict, err_state: dict, mesh,
            rules: shd.Rules | None = None):
    """Lay one-device training state out on ``mesh``: (ShardedModel,
    opt_state, err_state), each leaf cut by :func:`state_shardings`
    (``rules`` default ``make_rules("train")``)."""
    rules = rules or shd.make_rules("train")
    trees = {"params": trainable(model), "opt": opt_state, "err": err_state}
    return from_sharded_state(model, _cut(trees, state_shardings(cfg, trees, mesh, rules)), mesh, rules)


def gathered_state(model: ShardedModel, opt_state: dict, err_state: dict, device="cpu") -> dict:
    """Training state ``{"params", "opt", "err"}`` with every leaf whole on
    ``device``: the one-device layout a checkpoint holds."""
    def whole(tree):
        if isinstance(tree, dict):
            return {k: whole(v) for k, v in tree.items()}
        return tree.full(device) if isinstance(tree, shd.ShardedTensor) else tree

    return whole({"params": model.params, "opt": opt_state, "err": err_state})


def check_rows(batch_rows: int, mesh, n_micro: int) -> None:
    """Raise a ``ValueError`` unless ``batch_rows`` splits evenly over the
    mesh's data ranks and then into ``n_micro`` microbatches (the
    reference would de-shard such a batch silently)."""
    data = mesh.data_ranks
    if batch_rows % (data * n_micro):
        raise ValueError(
            f"a batch of {batch_rows} rows does not split over the data axis of the "
            f"{mesh.shape} mesh into {data} ranks x {n_micro} microbatches"
        )


def rank_rows(batch: dict, mesh, rules: shd.Rules, n_micro: int) -> list[dict]:
    """Each data rank's rows of ``batch``, in rank order, on the rank's
    device: the slice that the ``("batch", None, ...)`` spec gives
    position ``(di, 0)``."""
    shardings = {}
    for k, x in batch.items():
        check_rows(x.shape[0], mesh, n_micro)
        axes = ("batch",) + (None,) * (x.dim() - 1)
        shardings[k] = shd.NamedSharding(mesh, shd.spec_for(x.shape, axes, rules, mesh))
    return [{k: x[shardings[k].index(x.shape, di, 0)].to(mesh.device(di, 0)) for k, x in batch.items()}
            for di in range(mesh.data_ranks)]


def sharded_grads(
    cfg, model: ShardedModel, batch: dict, n_micro: int = 1,
    grad_shardings: dict | None = None, acc_dtype: torch.dtype = torch.float32,
) -> tuple[Tensor, dict[str, shd.ShardedTensor]]:
    """The loss (the mean of the data ranks' mean losses) and each
    parameter's gradient as a ``ShardedTensor``: each rank, in order, runs
    :func:`loss_and_grads` with ``n_micro`` microbatches, and the ranks'
    mean gradients are reduce-scattered onto ``grad_shardings[name]``
    (name → ``NamedSharding``) when it is given, else onto the
    parameter's layout."""
    ranks = rank_rows(batch, model.mesh, model.rules, n_micro)
    shd.all_gather(model.params, model.modules)
    losses, per_rank = [], []
    for di, rows in enumerate(ranks):
        loss, grads = loss_and_grads(cfg, model.module(model.mesh.device(di, 0)), rows, n_micro, acc_dtype)
        losses.append(loss)
        per_rank.append(grads)
    out = {n: shd.reduce_scatter([g.pop(n) for g in per_rank],
                                 grad_shardings[n] if grad_shardings else p.sharding)
           for n, p in model.params.items()}
    dev = model.mesh.device(0, 0)
    total = losses[0].to(dev)
    for loss in losses[1:]:
        total = total + loss.to(dev)
    return total / len(losses), out


def _relaid(t: shd.ShardedTensor, sharding: shd.NamedSharding) -> shd.ShardedTensor:
    """``t`` laid out by ``sharding`` (``t`` itself when it already is)."""
    if t.sharding == sharding:
        return t
    return shd.ShardedTensor.from_full(t.full(sharding.mesh.device(0, 0)), sharding)


@torch.no_grad()
def sharded_adamw(
    opt_cfg: AdamWConfig, params: dict, grads: dict, opt_state: dict,
    lr_scale: Tensor | float = 1.0,
) -> dict[str, Tensor]:
    """One AdamW step on tiles, in place: every position applies
    ``adamw.apply_update`` to its own tiles of ``p``, ``m`` and ``v``
    (``grads`` laid out like ``params``); the global norm sums each
    distinct tile once (a replica is not counted twice).  Returns the
    metrics ``grad_norm`` and ``clip_scale``."""
    dev = opt_state["step"].device
    gnorm = torch.sqrt(sum(torch.sum(torch.square(t.float())).to(dev)
                           for g in grads.values() for _, t in g.distinct()))
    c = adamw_lib.begin_step(opt_cfg, opt_state, gnorm, lr_scale)
    on = {dev: c}
    for name, p in params.items():
        g, m, v = grads[name], opt_state["m"][name], opt_state["v"][name]
        for pos in p.sharding.positions():
            d = p.sharding.mesh.device(*pos)
            if d not in on:
                on[d] = adamw_lib.StepCoefficients(*(t.to(d) for t in dataclasses.astuple(c)))
            adamw_lib.apply_update(opt_cfg, on[d], p.shard(*pos), g.shard(*pos),
                                   m.shard(*pos), v.shard(*pos))
    return {"grad_norm": gnorm, "clip_scale": c.scale}


def mesh_step(
    cfg, opt_cfg: AdamWConfig, model: ShardedModel, opt_state: dict, err_state: dict,
    batch: dict, n_micro: int = 1, lr_scale: Tensor | float = 1.0,
    compress_grads: bool = False, grad_shardings: dict | None = None,
    acc_dtype: torch.dtype = torch.float32,
) -> tuple[ShardedModel, dict, dict, dict]:
    """One training step on ``model``'s mesh (the module docstring's
    executor): :func:`sharded_grads`, error-feedback compression of each
    reduced gradient whole (``compress_grads``; ``err_state`` sharded
    like the parameters), :func:`sharded_adamw`, then the compute
    modules refreshed from the tiles.  Returns (model, opt_state,
    err_state, metrics) with ``loss``, ``grad_norm`` and ``clip_scale``."""
    loss, grads = sharded_grads(cfg, model, batch, n_micro, grad_shardings, acc_dtype)
    dev = model.mesh.device(0, 0)
    for name, p in model.params.items():
        g = grads[name]
        if compress_grads:
            e = err_state[name]
            comp, new_err = compress_gradients({name: g.full(dev)}, {name: e.full(dev)})
            err_state[name] = shd.ShardedTensor.from_full(new_err[name], e.sharding)
            g = shd.ShardedTensor.from_full(comp[name], p.sharding)
        grads[name] = _relaid(g, p.sharding)
    metrics = sharded_adamw(opt_cfg, model.params, grads, opt_state, lr_scale)
    shd.all_gather(model.params, model.modules)
    metrics["loss"] = loss
    return model, opt_state, err_state, metrics


def make_step_fn(cfg, opt_cfg: AdamWConfig, tc: TrainConfig) -> Callable:
    """(model, opt_state, err_state, batch, step) → (model, opt_state,
    err_state, metrics): gradients by :func:`loss_and_grads` (float32
    accumulation), compressed with error feedback when
    ``tc.compress_grads``, then one AdamW step at ``cosine_schedule(step,
    tc.lr_total_steps or tc.steps, tc.warmup)`` written into the model's
    trainable parameters and ``opt_state`` in place.  A
    :class:`ShardedModel` (with sharded ``opt_state`` and ``err_state``)
    takes the same step on its mesh by :func:`mesh_step`.  ``metrics``
    holds ``loss``, ``grad_norm`` and ``clip_scale`` as device tensors."""

    def step_fn(model, opt_state, err_state, batch, step):
        lr_scale = cosine_schedule(step, tc.lr_total_steps or tc.steps, tc.warmup)
        if isinstance(model, ShardedModel):
            return mesh_step(cfg, opt_cfg, model, opt_state, err_state, batch, tc.n_micro,
                             lr_scale, tc.compress_grads)
        loss, grads = loss_and_grads(cfg, model, batch, tc.n_micro)
        if tc.compress_grads:
            grads, err_state = compress_gradients(grads, err_state)
        _, opt_state, metrics = adamw_lib.adamw_update(
            opt_cfg, trainable(model), grads, opt_state, lr_scale=lr_scale
        )
        metrics["loss"] = loss
        return model, opt_state, err_state, metrics

    return step_fn


def _single_device(mesh, device):
    """The device to train on without a mesh: ``mesh``'s one device (a
    1 × 1 mesh) or ``device``."""
    if mesh is None:
        return resolve_device(device)
    return resolve_device(device if device is not None else mesh.device(0, 0))


@torch.no_grad()
def _copy_into(live: PyTree, stored: PyTree) -> None:
    """Copy a restored tree's host leaves into the live tensors in place."""
    if isinstance(live, dict):
        for k, v in live.items():
            _copy_into(v, stored[k])
    else:
        live.copy_(stored)


def train_loop(
    cfg,
    tc: TrainConfig,
    ckpt_dir: str,
    opt_cfg: AdamWConfig | None = None,
    failure: FailureInjector | None = None,
    mesh=None,
    log: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Run (or resume) training to ``tc.steps`` on ``device`` (None = the
    card) or on ``mesh``.  Returns the final metrics as floats, ``params``
    (the trained parameters by name, whole) and ``steps_done``.

    The model is drawn by the family's ``init_params`` from a generator
    seeded with ``tc.seed`` on the device (on a mesh, its first device);
    the latest checkpoint in ``ckpt_dir``, if any, then overwrites
    parameters, optimizer and error-feedback state.
    ``failure.check(step)`` runs before each step.  A checkpoint is saved
    every ``tc.save_every`` steps and at the end.

    ``mesh`` None or 1 × 1 trains on one device.  A larger ``LocalMesh``
    lays the state out on it (:func:`to_mesh`; a resume restores onto it
    by ``restore_resharded``) and steps by :func:`mesh_step` under
    ``sharding.activate(mesh, make_rules("train"))``; each checkpoint
    holds every leaf whole.  A batch that the mesh's data ranks and
    ``tc.n_micro`` do not divide raises a ``ValueError`` before any step."""
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3)
    on_mesh = mesh is not None and mesh.size > 1
    if on_mesh:
        check_rows(tc.batch, mesh, tc.n_micro)
        device = mesh.device(0, 0)
        rules = shd.make_rules("train")
    else:
        device = _single_device(mesh, device)
    mod = model_api.get_model(cfg)
    model = mod.init_params(cfg, torch.Generator(device).manual_seed(tc.seed), device=device)
    model.requires_grad_(True)
    params = trainable(model)
    opt_state = adamw_init(opt_cfg, params)
    err_state = compression_init(params) if tc.compress_grads else {}
    templates = {"params": params, "opt": opt_state, "err": err_state}

    mgr = CheckpointManager(ckpt_dir, keep=tc.keep, async_save=tc.async_ckpt)
    start_step = 0
    if on_mesh:
        latest = ckpt_lib.latest_step(ckpt_dir)
        if latest is None:
            state = to_mesh(cfg, model, opt_state, err_state, mesh, rules)
        else:
            with shd.activate(mesh, rules):
                held = ckpt_lib.restore_resharded(
                    ckpt_dir, latest, templates, state_shardings(cfg, templates, mesh, rules))
            state = from_sharded_state(model, held, mesh, rules)
            start_step = latest
        del params, opt_state, err_state, templates
        model, opt_state, err_state = state
        shd.all_gather(model.params, model.modules)
        scope = shd.activate(mesh, rules)
    else:
        restored = mgr.restore_latest(templates)
        if restored is not None:
            start_step, trees = restored
            _copy_into(templates, trees)
        scope = contextlib.nullcontext()
    if start_step:
        log(f"[train] resumed from step {start_step}")

    def saved_trees() -> dict:
        if on_mesh:
            return gathered_state(model, opt_state, err_state)
        return {"params": params, "opt": opt_state, "err": err_state}

    step_fn = make_step_fn(cfg, opt_cfg, tc)
    ds_cfg = token_data.TokenStreamConfig(vocab=cfg.vocab, seq_len=tc.seq, seed=tc.seed)
    metrics = {}
    with scope:
        for step in range(start_step, tc.steps):
            if failure is not None:
                failure.check(step)
            batch_np = token_data.batch_at_step(ds_cfg, step, tc.batch)
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
            t0 = time.time()
            model, opt_state, err_state, metrics = step_fn(model, opt_state, err_state, batch, step)
            if (step + 1) % tc.save_every == 0 or step + 1 == tc.steps:
                mgr.save(step + 1, saved_trees())
            if step % 10 == 0 or step + 1 == tc.steps:
                log(
                    f"[train] step {step} loss {float(metrics['loss']):.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"({time.time() - t0:.2f}s)"
                )
    mgr.wait()
    if on_mesh:
        params = trainable(model.module())
    final = {k: float(v) for k, v in metrics.items()}
    final["params"] = params
    final["steps_done"] = tc.steps
    return final


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    cfg = (
        configs.get_smoke_config(args.arch)
        if args.smoke
        else configs.get_config(args.arch)
    )
    tc = TrainConfig(
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        save_every=args.save_every,
        compress_grads=args.compress_grads,
        n_micro=args.n_micro,
    )
    out = train_loop(cfg, tc, args.ckpt_dir, device=args.device)
    print(f"final loss: {out['loss']:.4f}")


if __name__ == "__main__":
    main()
