"""State carried across from the JAX reference.

:func:`fused_grating_from_numpy` builds a port
:class:`~repro_torch.core.engine.FusedGrating` from a reference
grating's fields passed as numpy arrays plus its metadata, so a test can
hold port *queries* against reference queries on the very same recorded
grating, apart from record parity.  :func:`mamba2_params_from_numpy`
and :func:`transformer_params_from_numpy` load a reference Mamba-2 or
dense-transformer parameter tree into the port's module.  Tenant kernel
sets are numpy on both sides and need no conversion.  All take
``device=None`` to mean the card, as every port entry point does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.engine import FusedGrating
from repro_torch.models import mamba2, transformer


def _to_torch(arr, device) -> torch.Tensor | None:
    """A numpy array as a tensor; bfloat16 arrays (numpy's extension
    dtype) travel as their 16-bit patterns."""
    if arr is None:
        return None
    arr = np.array(arr)  # a writable copy torch can wrap
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def fused_grating_from_numpy(fields: dict, device: str | None = None) -> FusedGrating:
    """Rebuild a recorded grating from its fields.

    ``fields`` maps the reference ``FusedGrating``'s field names to
    numpy arrays (``effective``, ``stacked``, ``eff_re``, ``eff_im``,
    ``kernel_scale``, ``echo_gain``; absent or None where the reference
    held None) and to its metadata (``fft_shape``, ``out_shape``,
    ``ker_shape``, ``encode``, ``slm_bits``, ``pseudo_negative``,
    ``storage_dtype``).
    """
    device = resolve_device(device)
    return FusedGrating(
        stacked=_to_torch(fields.get("stacked"), device),
        effective=_to_torch(fields.get("effective"), device),
        fft_shape=tuple(int(n) for n in fields["fft_shape"]),
        out_shape=tuple(int(n) for n in fields["out_shape"]),
        kernel_scale=_to_torch(fields["kernel_scale"], device),
        echo_gain=_to_torch(fields["echo_gain"], device),
        encode=bool(fields.get("encode", False)),
        slm_bits=int(fields.get("slm_bits", 8)),
        ker_shape=(
            None
            if fields.get("ker_shape") is None
            else tuple(int(n) for n in fields["ker_shape"])
        ),
        pseudo_negative=bool(fields.get("pseudo_negative", False)),
        eff_re=_to_torch(fields.get("eff_re"), device),
        eff_im=_to_torch(fields.get("eff_im"), device),
        storage_dtype=str(fields.get("storage_dtype", "float32")),
    )


def _put(p: torch.nn.Parameter, arr, name: str) -> None:
    t = _to_torch(arr, p.device)
    if t.shape != p.shape or t.dtype != p.dtype:
        raise ValueError(
            f"{name}: got {tuple(t.shape)} {t.dtype}, the model holds "
            f"{tuple(p.shape)} {p.dtype}"
        )
    p.copy_(t)


def _load(model, params: dict, cfg, fields) -> None:
    """Copy a reference tree's ``embed``, ``final_norm``, ``lm_head``
    (untied only) and stacked ``layers`` fields into ``model``."""
    _put(model.embed, params["embed"], "embed")
    _put(model.final_norm, params["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _put(model.lm_head, params["lm_head"], "lm_head")
    for name in fields:
        stacked = np.asarray(params["layers"][name])
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{name} stacks {stacked.shape[0]} layers, cfg has {cfg.n_layers}")
        for i, block in enumerate(model.layers):
            _put(getattr(block, name), stacked[i], f"layers.{name}[{i}]")


@torch.no_grad()
def mamba2_params_from_numpy(params: dict, cfg: mamba2.Mamba2Config, device=None) -> mamba2.Mamba2:
    """The port's :class:`~repro_torch.models.mamba2.Mamba2` holding a
    reference parameter tree.

    ``params`` is the reference ``init_params`` tree with numpy leaves:
    ``embed``, ``final_norm``, ``lm_head`` when the embeddings are not
    tied, and ``layers`` mapping each of ``mamba2.LAYER_FIELDS`` to an
    array stacked on axis 0, one slice per block.  Every array must have
    the shape and dtype the port's module holds for ``cfg``.
    """
    model = mamba2.Mamba2(cfg, resolve_device(device))
    _load(model, params, cfg, mamba2.LAYER_FIELDS)
    return model


@torch.no_grad()
def transformer_params_from_numpy(
    params: dict, cfg: transformer.TransformerConfig, device=None
) -> transformer.Transformer:
    """The port's :class:`~repro_torch.models.transformer.Transformer`
    holding a reference parameter tree, as
    :func:`mamba2_params_from_numpy`.  ``layers`` must hold exactly the
    fields of ``transformer.LAYER_FIELDS`` that ``cfg`` has (the biases
    with ``qkv_bias``, ``w_gate`` with the SwiGLU MLP)."""
    model = transformer.Transformer(cfg, resolve_device(device))
    fields = transformer.layer_shapes(cfg)
    if set(params["layers"]) != set(fields):
        raise ValueError(
            f"layers hold {sorted(params['layers'])}, cfg {cfg.name!r} has {sorted(fields)}"
        )
    _load(model, params, cfg, fields)
    return model
