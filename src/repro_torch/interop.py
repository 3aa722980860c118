"""State carried across from the JAX reference.

:func:`fused_grating_from_numpy` builds a port
:class:`~repro_torch.core.engine.FusedGrating` from a reference
grating's fields passed as numpy arrays plus its metadata, so a test can
hold port *queries* against reference queries on the very same recorded
grating, apart from record parity.  :func:`mamba2_params_from_numpy`,
:func:`transformer_params_from_numpy`, :func:`zamba_params_from_numpy`,
:func:`moe_params_from_numpy`, :func:`mla_params_from_numpy`,
:func:`vlm_params_from_numpy` and :func:`whisper_params_from_numpy` load
a reference Mamba-2, dense-transformer, Zamba-2, MoE, MLA, VLM or
Whisper parameter tree into the port's module, and
:func:`hybrid_params_from_numpy` the hybrid 3-D CNN's parameters.  Tenant kernel
sets are numpy on both sides and need no conversion.  All take
``device=None`` to mean the card, as every port entry point does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hybrid
from repro_torch.core.engine import FusedGrating
from repro_torch.models import mamba2, mla, moe, transformer, vlm, whisper, zamba


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


def _fields(module: torch.nn.Module) -> dict:
    """A module's own parameters (None) and its child modules (their
    fields), by name: the layout of one layer of a reference tree."""
    out: dict = {name: None for name, _ in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        out[name] = _fields(child)
    return out


def _same_keys(tree: dict, want, where: str) -> None:
    if set(tree) != set(want):
        missing, extra = sorted(set(want) - set(tree)), sorted(set(tree) - set(want))
        raise ValueError(f"{where} hold {sorted(tree)}: missing {missing}, extra {extra}")


def _load_stack(blocks, tree: dict, where: str) -> None:
    """Copy a stacked layer tree (each leaf (len(blocks), ...), a nested
    dict for each child module) into ``blocks``, checking every field by
    name, stack length, shape and dtype."""
    want = _fields(blocks[0])
    _same_keys(tree, want, where)
    for name, sub in tree.items():
        if (want[name] is None) == isinstance(sub, dict):
            raise ValueError(
                f"{where}.{name}: got a {'tree' if isinstance(sub, dict) else 'leaf'}, "
                f"the model holds a {'leaf' if want[name] is None else 'tree'}"
            )
        if isinstance(sub, dict):
            _load_stack([getattr(b, name) for b in blocks], sub, f"{where}.{name}")
            continue
        arr = np.asarray(sub)
        if arr.shape[:1] != (len(blocks),):
            raise ValueError(f"{where}.{name} stacks {arr.shape[:1]} layers, the model has {len(blocks)}")
        for i, b in enumerate(blocks):
            _put(getattr(b, name), arr[i], f"{where}.{name}[{i}]")


def _load_module(module: torch.nn.Module, tree: dict, where: str) -> None:
    """Copy one unstacked subtree (a dict per child module) into
    ``module``, checking every field by name, shape and dtype."""
    if not isinstance(tree, dict):
        raise ValueError(f"{where}: got a leaf, the model holds a tree")
    _same_keys(tree, _fields(module), where)
    for name, sub in tree.items():
        child = getattr(module, name)
        if isinstance(child, torch.nn.Module):
            _load_module(child, sub, f"{where}.{name}")
        elif isinstance(sub, dict):
            raise ValueError(f"{where}.{name}: got a tree, the model holds a leaf")
        else:
            _put(child, sub, f"{where}.{name}")


def _load_tree(model, params: dict, stacks: dict, others=()) -> None:
    """Copy a reference tree's ``embed``, ``final_norm``, ``lm_head`` (where
    the model holds one) and each stacked layer tree named in ``stacks``
    into ``model``; ``others`` are top-level keys the caller loads.  Any
    field missing, extra, or of another shape or dtype raises a
    ``ValueError`` that names it."""
    top = [n for n in ("embed", "final_norm", "lm_head") if hasattr(model, n)]
    _same_keys(params, [*top, *stacks, *others], "params")
    for name in top:
        _put(getattr(model, name), params[name], name)
    for name, blocks in stacks.items():
        _load_stack(blocks, params[name], name)


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
    _load_tree(model, params, {"layers": model.layers})
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
    _load_tree(model, params, {"layers": model.layers})
    return model


@torch.no_grad()
def zamba_params_from_numpy(params: dict, cfg: zamba.ZambaConfig, device=None) -> zamba.Zamba:
    """The port's :class:`~repro_torch.models.zamba.Zamba` holding a
    reference parameter tree.

    ``params`` is the reference ``init_params`` tree with numpy leaves:
    ``embed``, ``final_norm``, ``lm_head`` when the embeddings are not
    tied, ``layers`` mapping each of ``mamba2.LAYER_FIELDS`` to an array
    stacked as (n_segments, shared_every, ...), flattened here onto the
    ``n_layers`` blocks in order, and ``shared`` mapping each of
    ``zamba.SHARED_FIELDS`` to its array.  A field that is missing, extra,
    or of another shape or dtype than the port's module holds for ``cfg``
    raises a ``ValueError`` that names it."""
    model = zamba.Zamba(cfg, resolve_device(device))
    for group, want in (("layers", mamba2.LAYER_FIELDS), ("shared", zamba.SHARED_FIELDS)):
        if set(params[group]) != set(want):
            raise ValueError(f"{group} hold {sorted(params[group])}, cfg {cfg.name!r} has {sorted(want)}")
    lead = (cfg.n_segments, cfg.shared_every)
    layers = {}
    for name in mamba2.LAYER_FIELDS:
        arr = np.asarray(params["layers"][name])
        if arr.shape[:2] != lead:
            raise ValueError(
                f"layers.{name} stacks {arr.shape[:2]}, cfg has (n_segments, shared_every) = {lead}"
            )
        layers[name] = arr.reshape((-1,) + arr.shape[2:])
    _load_tree(model, {**params, "layers": layers}, {"layers": model.layers}, ("shared",))
    for name in zamba.SHARED_FIELDS:
        _put(getattr(model.shared, name), params["shared"][name], f"shared.{name}")
    return model


@torch.no_grad()
def moe_params_from_numpy(params: dict, cfg: moe.MoEConfig, device=None) -> moe.MoE:
    """The port's :class:`~repro_torch.models.moe.MoE` holding a reference
    parameter tree (numpy leaves): ``embed``, ``final_norm``, ``lm_head``
    when the embeddings are not tied, and ``layers``, each field stacked
    on axis 0 with the MoE's under ``layers.moe`` (``router`` float32).
    A field that is missing, extra, or of another shape or dtype than the
    port's module holds for ``cfg`` raises a ``ValueError`` that names it."""
    model = moe.MoE(cfg, resolve_device(device))
    _load_tree(model, params, {"layers": model.layers})
    return model


@torch.no_grad()
def mla_params_from_numpy(params: dict, cfg: mla.MLAConfig, device=None) -> mla.MLA:
    """The port's :class:`~repro_torch.models.mla.MLA` holding a reference
    parameter tree, as :func:`moe_params_from_numpy`: ``embed``,
    ``final_norm``, ``lm_head``, the stacked ``dense_layers`` (when
    ``first_k_dense``) and the stacked MoE ``layers``."""
    model = mla.MLA(cfg, resolve_device(device))
    stacks = {"layers": model.layers}
    if cfg.first_k_dense:
        stacks["dense_layers"] = model.dense_layers
    _load_tree(model, params, stacks)
    return model


@torch.no_grad()
def vlm_params_from_numpy(params: dict, cfg: vlm.VLMConfig, device=None) -> vlm.VLM:
    """The port's :class:`~repro_torch.models.vlm.VLM` holding a reference
    parameter tree: the dense transformer's (``embed``, ``final_norm``,
    ``lm_head`` when the embeddings are not tied, the stacked ``layers``),
    as :func:`transformer_params_from_numpy`."""
    model = vlm.VLM(cfg, resolve_device(device))
    _load_tree(model, params, {"layers": model.layers})
    return model


@torch.no_grad()
def whisper_params_from_numpy(
    params: dict, cfg: whisper.WhisperConfig, device=None
) -> whisper.Whisper:
    """The port's :class:`~repro_torch.models.whisper.Whisper` holding a
    reference parameter tree (numpy leaves): ``embed``, ``dec_pos``,
    ``enc_ln_post`` and ``dec_ln_post`` (``{w, b}``), and the stacked
    ``enc_layers`` and ``dec_layers``, each a nested tree (``ln1``,
    ``attn`` or ``self_attn`` and ``cross_attn``, ..., attention
    ``{wq, wk, wv, wo, bq, bv, bo}``, no ``bk``) whose leaves stack the
    layers on axis 0.  A field that is missing, extra, or of another shape
    or dtype than the port's module holds for ``cfg`` raises a
    ``ValueError`` that names it."""
    model = whisper.Whisper(cfg, resolve_device(device))
    others = ("dec_pos", "enc_ln_post", "dec_ln_post")
    _load_tree(model, params, {"enc_layers": model.enc_layers, "dec_layers": model.dec_layers},
               others)
    _put(model.dec_pos, params["dec_pos"], "dec_pos")
    for name in others[1:]:
        _load_module(getattr(model, name), params[name], name)
    return model


@torch.no_grad()
def hybrid_params_from_numpy(
    params: dict, cfg: hybrid.HybridConfig, device=None
) -> hybrid.HybridCNN:
    """The port's :class:`~repro_torch.core.hybrid.HybridCNN` holding the
    reference hybrid's parameter dict (``conv_w``, ``conv_b``, ``fc1_w``,
    ``fc1_b``, ``fc2_w``, ``fc2_b`` as numpy arrays, in the reference's
    layouts: ``fc1_w`` is (features, hidden)).  Every array must have the
    shape and dtype ``cfg`` gives it."""
    model = hybrid.HybridCNN(cfg, resolve_device(device))
    if set(params) != set(hybrid.param_shapes(cfg)):
        raise ValueError(f"params hold {sorted(params)}, the hybrid has {sorted(hybrid.param_shapes(cfg))}")
    for name in params:
        _put(getattr(model, name), params[name], name)
    return model
