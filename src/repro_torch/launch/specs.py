"""Input specs and step functions for every (architecture × shape) cell
(port of ``repro.launch.specs``).

``input_specs(cfg, shape)`` returns tensors on the ``meta`` device for
every model input (shape and dtype, nothing allocated), the port's
counterpart of the reference's ``ShapeDtypeStruct`` stand-ins;
``params_specs``, ``opt_specs`` and ``decode_cache_specs`` build the
model, the optimizer state and the decode cache on ``meta`` as the
reference's ``jax.eval_shape`` traces them.  ``make_train_step`` and
``make_serve_step`` return the function a cell runs: the train step for
training shapes, prefill or one decode token for inference shapes.

``params_specs`` and ``decode_cache_specs`` return the tensors alone;
``params_logical_axes`` and ``decode_cache_logical_axes`` give their
logical axes (the second values of the reference's pair), keyed by the
port's parameter names and cache keys, for ``distributed.sharding``'s
rules.  ``make_train_step(grad_shardings=...)`` runs the train step on
the mesh of its shardings (``launch.train.mesh_step``, over a
``launch.train.ShardedModel``).

The shape set (LM family):

  train_4k     seq 4096   global_batch 256   → train step
  prefill_32k  seq 32768  global_batch 32    → serve step (prefill)
  decode_32k   KV 32768   global_batch 128   → serve step (1 new token)
  long_500k    KV 524288  global_batch 1     → serve step (1 new token);
               SSM / hybrid only (sub-quadratic sequence mixing)
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch import interop
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch import train as train_lib
from repro_torch.models import mamba2, mla, model_api, moe, transformer, vlm, whisper, zamba
from repro_torch.optim import adamw

Tensor = torch.Tensor
PyTree = Any

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, mode="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, mode="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, mode="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, mode="decode"),
}

# Microbatch counts for training: activation memory ÷ n_micro must fit
# beside the sharded parameters and optimizer state.
GRAD_ACCUM = {
    "llama3-405b": 16,
    "arctic-480b": 8,
    "nemotron-4-15b": 4,
    "granite-8b": 2,
    "deepseek-v2-lite-16b": 2,
}

# each family module's model class
_MODELS = {
    transformer: transformer.Transformer, mamba2: mamba2.Mamba2, zamba: zamba.Zamba,
    moe: moe.MoE, mla: mla.MLA, whisper: whisper.Whisper, vlm: vlm.VLM,
}


def shape_applicable(cfg, shape: str) -> tuple[bool, str]:
    """Is this (arch, shape) cell runnable?  (per the assignment rules)"""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, (
            "long_500k requires sub-quadratic sequence mixing; "
            f"{cfg.name} is full-attention → skipped (DESIGN.md §Arch-applicability)"
        )
    return True, ""


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape: str) -> dict[str, Tensor]:
    """``meta`` tensors standing in for the step's *data* inputs."""
    info = SHAPES[shape]
    B, S = info["global_batch"], info["seq_len"]
    mode = info["mode"]
    f32, i32 = torch.float32, torch.int32

    if mode == "decode":  # one new token against a seq_len-deep cache
        return {"tokens": _meta((B, 1), i32)}
    batch = {"tokens": _meta((B, S), i32)}
    if mode == "train":
        batch["labels"] = _meta((B, S), i32)
    if cfg.family == "audio":
        batch["frames"] = _meta((B, cfg.n_frames, cfg.d_model), f32)
    if cfg.family == "vlm":
        batch["patches"] = _meta((B, cfg.n_patches, cfg.d_model), f32)
    return batch


def batch_logical_axes(cfg, shape: str) -> dict[str, tuple]:
    """Logical axes for each data input (batch dim shards over DP)."""
    out: dict[str, tuple] = {}
    for key in input_specs(cfg, shape):
        if key in ("tokens", "labels"):
            out[key] = ("batch", None)
        else:  # frames / patches
            out[key] = ("batch", None, None)
    return out


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def make_train_step(
    cfg,
    opt_cfg: adamw.AdamWConfig,
    n_micro: int = 1,
    grad_shardings: Any | None = None,
    grad_dtype: torch.dtype = torch.float32,
) -> Callable:
    """(model, opt_state, batch) → (model, opt_state, metrics).

    Microbatched: the global batch is split into ``n_micro`` chunks run in
    turn, each chunk's gradients cast to ``grad_dtype`` and accumulated;
    activation memory scales with B / n_micro.  The AdamW step writes the
    trainable parameters and ``opt_state`` in place.

    ``grad_shardings`` (parameter name → ``NamedSharding``, all on one
    mesh; a name missing, a leaf of another type or a second mesh raises
    a ``ValueError`` naming the leaf) lays the reduced gradients out on
    that mesh: the step is ``launch.train.mesh_step`` there, the data
    ranks' mean gradients reduce-scattered onto those layouts and then
    re-cut onto the parameters' for the tile update, and ``model`` is a
    ``launch.train.ShardedModel`` on that mesh with sharded
    ``opt_state`` (``launch.train.to_mesh``).  A ``ShardedModel`` without
    ``grad_shardings`` takes the mesh step with the parameters' layout."""
    mesh = _check_grad_shardings(cfg, grad_shardings) if grad_shardings is not None else None

    def train_step(model, opt_state, batch):
        if isinstance(model, train_lib.ShardedModel) or mesh is not None:
            if mesh is not None and model.mesh != mesh:
                raise ValueError(f"grad_shardings lie on {mesh.shape}, the model on another mesh")
            model, opt_state, _, metrics = train_lib.mesh_step(
                cfg, opt_cfg, model, opt_state, {}, batch, n_micro,
                grad_shardings=grad_shardings, acc_dtype=grad_dtype,
            )
            return model, opt_state, metrics
        loss, grads = train_lib.loss_and_grads(cfg, model, batch, n_micro, grad_dtype)
        _, opt_state, metrics = adamw.adamw_update(
            opt_cfg, train_lib.trainable(model), grads, opt_state
        )
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def _check_grad_shardings(cfg, grad_shardings) -> Any:
    """The one mesh of ``grad_shardings``: a ``NamedSharding`` for every
    parameter of ``cfg``'s model and nothing else, else a ``ValueError``
    naming the leaf."""
    if not isinstance(grad_shardings, dict):
        raise ValueError(f"grad_shardings must map parameter names to NamedShardings, got "
                         f"{type(grad_shardings).__name__}")
    names = list(params_specs(cfg))
    for name in names:
        if name not in grad_shardings:
            raise ValueError(f"grad_shardings has no entry for parameter {name!r}")
    mesh = None
    for name, s in grad_shardings.items():
        if name not in names:
            raise ValueError(f"grad_shardings names {name!r}, which is not a parameter of {cfg.name}")
        if not isinstance(s, NamedSharding):
            raise ValueError(f"grad_shardings[{name!r}] is a {type(s).__name__}, not a NamedSharding")
        if mesh is None:
            mesh = s.mesh
        elif s.mesh != mesh:
            raise ValueError(f"grad_shardings[{name!r}] lies on another mesh than the first leaf's")
    return mesh


def make_serve_step(cfg, shape: str) -> Callable:
    """Prefill: (model, batch) → (logits, cache).
    Decode:  (model, cache, tokens) → (logits, cache).

    The prefill's cache holds ``seq_len`` positions; the VLM's ``max_len``
    counts its patches, so its cache holds ``n_patches + seq_len`` (the
    reference passes ``seq_len`` and clamps the cache writes past it)."""
    info = SHAPES[shape]

    if info["mode"] == "prefill":

        def prefill_step(model, batch):
            if cfg.family == "vlm":
                return model.prefill(batch, max_len=cfg.n_patches + info["seq_len"])
            if cfg.family == "audio":
                return model.prefill(batch, max_len=info["seq_len"])
            return model.prefill(batch["tokens"], max_len=info["seq_len"])

        return prefill_step

    def decode_step(model, cache, tokens):
        return model.decode_step(cache, tokens)

    return decode_step


def abstract_model(cfg) -> torch.nn.Module:
    """The config's model with its parameters on the ``meta`` device."""
    return _MODELS[model_api.get_model(cfg)](cfg, "meta")


def decode_cache_specs(cfg, shape: str) -> dict:
    """The decode cache of a decode shape, its tensors on ``meta``."""
    info = SHAPES[shape]
    return abstract_model(cfg).init_cache(info["global_batch"], info["seq_len"])


def params_specs(cfg) -> dict[str, Tensor]:
    """Every parameter by name, on ``meta``: nothing allocated."""
    return dict(abstract_model(cfg).named_parameters())


def decode_cache_logical_axes(cfg, shape: str) -> dict[str, tuple]:
    """The logical axes of each tensor of ``decode_cache_specs(cfg,
    shape)``, by cache key (the port's cache stacks its layers as the
    reference's does, so these are the reference's axes)."""
    axes = model_api.get_model(cfg).CACHE_AXES
    return {k: axes[k] for k in decode_cache_specs(cfg, shape)}


# the stacked axes a reference layer tree leads with (Zamba-2 stacks its
# Mamba-2 layers as (n_segments, shared_every))
_STACKED = ("segments", "layers")


def _over_layers(tree, n_layers: int, cfg):
    """A stacked layer tree's axes with each leaf an array over the
    layers, every element the axes of one layer's tensor (the stacked
    entries dropped): the layout the interop loaders take a stack in."""
    if isinstance(tree, dict):
        return {k: _over_layers(v, n_layers, cfg) for k, v in tree.items()}
    k = 2 if tree[:2] == _STACKED else 1
    arr = np.empty((cfg.n_segments, n_layers // cfg.n_segments) if k == 2 else (n_layers,), object)
    arr.fill(tree[k:])
    return arr


def params_logical_axes(cfg) -> dict[str, tuple]:
    """Each parameter's logical axes by its name in ``params_specs``.

    The family's ``logical_axes`` gives the reference's tree (layers
    stacked, their axes led by ``layers``); the interop loaders' walk
    (``interop.leaves_by_name``) carries it onto the port's names, each
    layer's tensor taking the stacked axes without their ``layers`` (and
    ``segments``) entries: ``layers.3.w_up`` gets ``("embed", "mlp")``."""
    model = abstract_model(cfg)
    tree = {
        k: _over_layers(v, len(getattr(model, k)), cfg)
        if isinstance(getattr(model, k, None), torch.nn.ModuleList) else v
        for k, v in model_api.get_model(cfg).logical_axes(cfg).items()
    }
    return interop.leaves_by_name(model, tree)


def opt_specs(opt_cfg: adamw.AdamWConfig, params_sds: dict[str, Tensor]) -> dict:
    """The AdamW state of ``params_sds``, on their (``meta``) device."""
    return adamw.adamw_init(opt_cfg, params_sds)


def opt_logical_axes(param_axes):
    """Optimizer state inherits parameter logical axes (m, v)."""
    return {"m": param_axes, "v": param_axes, "step": ()}
