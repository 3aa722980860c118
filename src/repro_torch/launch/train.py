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

Sharded training state is not here: ``mesh`` may be ``None`` or a 1 × 1
``LocalMesh``; a larger mesh raises ``NotImplementedError`` (ROADMAP
A.7b).

CLI (smoke scale; ``--device cpu`` on a host without a card):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import tokens as token_data
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
        mb = {k: x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])[i] for k, x in batch.items()}
        loss = mod.loss_fn(cfg, model, mb)
        for name, g in zip(names, torch.autograd.grad(loss, leaves)):
            acc[name].add_(g.to(acc_dtype))
        loss_sum = loss_sum + loss.detach()
    return loss_sum / n_micro, {n: g / n_micro for n, g in acc.items()}


def make_step_fn(cfg, opt_cfg: AdamWConfig, tc: TrainConfig) -> Callable:
    """(model, opt_state, err_state, batch, step) → (model, opt_state,
    err_state, metrics): gradients by :func:`loss_and_grads` (float32
    accumulation), compressed with error feedback when
    ``tc.compress_grads``, then one AdamW step at ``cosine_schedule(step,
    tc.lr_total_steps or tc.steps, tc.warmup)`` written into the model's
    trainable parameters and ``opt_state`` in place.  ``metrics`` holds
    ``loss``, ``grad_norm`` and ``clip_scale`` as device tensors."""

    def step_fn(model, opt_state, err_state, batch, step):
        loss, grads = loss_and_grads(cfg, model, batch, tc.n_micro)
        if tc.compress_grads:
            grads, err_state = compress_gradients(grads, err_state)
        lr_scale = cosine_schedule(step, tc.lr_total_steps or tc.steps, tc.warmup)
        _, opt_state, metrics = adamw_lib.adamw_update(
            opt_cfg, trainable(model), grads, opt_state, lr_scale=lr_scale
        )
        metrics["loss"] = loss
        return model, opt_state, err_state, metrics

    return step_fn


def _single_device(mesh, device):
    """The device to train on: ``mesh``'s one device (a 1 × 1 mesh) or
    ``device``; a larger mesh raises."""
    if mesh is None:
        return resolve_device(device)
    if mesh.size != 1:
        raise NotImplementedError(
            f"training on a {mesh.shape} mesh needs sharded training state, which is not "
            "ported to the torch package yet (ROADMAP A.7b); pass mesh=None or a 1 x 1 mesh"
        )
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
    card).  Returns the final metrics as floats, ``params`` (the trained
    parameters by name) and ``steps_done``.

    The model is drawn by the family's ``init_params`` from a generator
    seeded with ``tc.seed`` on the device; the latest checkpoint in
    ``ckpt_dir``, if any, then overwrites parameters, optimizer and
    error-feedback state.  ``failure.check(step)`` runs before each step.
    A checkpoint is saved every ``tc.save_every`` steps and at the end."""
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3)
    device = _single_device(mesh, device)
    mod = model_api.get_model(cfg)
    model = mod.init_params(cfg, torch.Generator(device).manual_seed(tc.seed), device=device)
    model.requires_grad_(True)
    params = trainable(model)
    opt_state = adamw_init(opt_cfg, params)
    err_state = compression_init(params) if tc.compress_grads else {}

    mgr = CheckpointManager(ckpt_dir, keep=tc.keep, async_save=tc.async_ckpt)
    start_step = 0
    restored = mgr.restore_latest({"params": params, "opt": opt_state, "err": err_state})
    if restored is not None:
        start_step, trees = restored
        _copy_into({"params": params, "opt": opt_state, "err": err_state}, trees)
        log(f"[train] resumed from step {start_step}")

    step_fn = make_step_fn(cfg, opt_cfg, tc)
    ds_cfg = token_data.TokenStreamConfig(vocab=cfg.vocab, seq_len=tc.seq, seed=tc.seed)
    metrics = {}
    for step in range(start_step, tc.steps):
        if failure is not None:
            failure.check(step)
        batch_np = token_data.batch_at_step(ds_cfg, step, tc.batch)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
        t0 = time.time()
        model, opt_state, err_state, metrics = step_fn(model, opt_state, err_state, batch, step)
        if (step + 1) % tc.save_every == 0 or step + 1 == tc.steps:
            mgr.save(step + 1, {"params": params, "opt": opt_state, "err": err_state})
        if step % 10 == 0 or step + 1 == tc.steps:
            log(
                f"[train] step {step} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({time.time() - t0:.2f}s)"
            )
    mgr.wait()
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
