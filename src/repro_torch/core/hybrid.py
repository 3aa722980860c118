"""Hybrid optoelectronic 3-D CNN (port of ``repro.core.hybrid``; paper
§3.2, §4).

Architecture exactly as the paper's proof of concept:

  input clip (C=1, 60×80, 16 frames)
    → 3-D conv layer, 9 kernels of 30×40×8, valid    ← *this* layer is the
      STHC in the optical system; digital twin for training
    → bias + ReLU                                     (digital)
    → 3-D max-pool                                    (digital)
    → flatten → FC → ReLU → FC → 4 classes            (digital)

The ``impl`` switch selects the conv backend:

  'digital'        direct correlation, ``kernels.conv3d.ops.conv3d``:
                   kernel B4 on the card (the reference runs a lax.conv
                   here; the function is the same)
  'spectral'       FFT correlator, ideal fidelity (numerically ≡ digital)
  'sthc_physical'  full physical model (the fidelity.physical() stage
                   stack) through a shared default correlator
  'sthc_ideal'     the ideal STHC through a shared default correlator
  'sthc'           caller-supplied STHC — any fidelity pipeline

The STHC backends run the spectral MAC on kernel B1 on the card.  The
parameters live in a :class:`HybridCNN` module under the reference's
names and layouts (``fc1_w`` is (features, hidden), applied as
``y @ W``) and require a gradient: :func:`loss_fn` gives a graph that
``.backward()`` trains through on the ``digital`` route (B4's backward
recomputes through its plain version) and the ``spectral`` one (plain
torch FFTs).  The STHC routes are inference-only on the card, as the
reference's B1 has no backward: B1 raises rather than cut a graph.
:func:`predict` runs under ``torch.no_grad()``.

:func:`max_pool3d` is an ``amax``, whose backward splits a tied
window's gradient among the tied elements where the reference's
``reduce_window`` gives it to one; the two agree wherever the tie is
ReLU's zeros (the derivative of ReLU at 0 is 0 in both packages).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import fidelity, spectral_conv
from repro_torch.core.engine import as_tensor, stage_clips
from repro_torch.core.sthc import STHC, STHCConfig
from repro_torch.kernels.conv3d import ops as conv3d_ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    height: int = 60
    width: int = 80
    frames: int = 16
    in_channels: int = 1
    num_kernels: int = 9  # the paper's 9 parallel optical channels
    k_h: int = 30
    k_w: int = 40
    k_t: int = 8
    pool_window: tuple[int, int, int] = (8, 8, 3)
    hidden: int = 128
    num_classes: int = 4
    dtype: Any = torch.float32

    @property
    def conv_out_shape(self) -> tuple[int, int, int]:
        return (
            self.height - self.k_h + 1,
            self.width - self.k_w + 1,
            self.frames - self.k_t + 1,
        )

    @property
    def pooled_features(self) -> int:
        oh, ow, ot = self.conv_out_shape
        ph, pw, pt = self.pool_window
        n = ((oh - ph) // ph + 1) * ((ow - pw) // pw + 1) * ((ot - pt) // pt + 1)
        return n * self.num_kernels


def param_shapes(cfg: HybridConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, as the reference's tree has them."""
    return {
        "conv_w": (cfg.num_kernels, cfg.in_channels, cfg.k_h, cfg.k_w, cfg.k_t),
        "conv_b": (cfg.num_kernels,),
        "fc1_w": (cfg.pooled_features, cfg.hidden),
        "fc1_b": (cfg.hidden,),
        "fc2_w": (cfg.hidden, cfg.num_classes),
        "fc2_b": (cfg.num_classes,),
    }


class HybridCNN(nn.Module):
    """The hybrid network's parameters (zeros until loaded or initialized);
    calling it runs :func:`forward`."""

    def __init__(self, cfg: HybridConfig, device: str):
        super().__init__()
        self.cfg = cfg
        for name, shape in param_shapes(cfg).items():
            t = torch.zeros(shape, dtype=cfg.dtype, device=device)
            setattr(self, name, nn.Parameter(t))

    def forward(self, x, impl: str = "digital", sthc: STHC | None = None) -> Tensor:
        return forward(self, x, self.cfg, impl=impl, sthc=sthc)


@torch.no_grad()
def init_params(
    cfg: HybridConfig, generator: torch.Generator | None = None, device=None
) -> HybridCNN:
    """He-scaled normal weights, zero biases (the reference's scales).

    ``generator`` (on ``device``) makes the draw reproducible; the draws
    differ from the reference's ``jax.random`` ones."""
    model = HybridCNN(cfg, resolve_device(device))
    fan_in = cfg.in_channels * cfg.k_h * cfg.k_w * cfg.k_t
    for name, fan in (("conv_w", fan_in), ("fc1_w", cfg.pooled_features), ("fc2_w", cfg.hidden)):
        p = getattr(model, name)
        p.copy_(torch.randn(p.shape, generator=generator, dtype=p.dtype, device=p.device))
        p.mul_((2.0 / fan) ** 0.5)
    return model


def max_pool3d(x: Tensor, window: tuple[int, int, int]) -> Tensor:
    """Valid 3-D max pooling, stride = window, over the trailing (H, W, T)
    axes of (B, O, H, W, T).  NaN propagates and an all −inf window gives
    −inf, as ``reduce_window(-inf, max)``."""
    ph, pw, pt = window
    B, O, H, W, T = x.shape
    nh, nw, nt = H // ph, W // pw, T // pt
    x = x[..., : nh * ph, : nw * pw, : nt * pt]
    x = x.reshape(B, O, nh, ph, nw, pw, nt, pt)
    return torch.amax(x, dim=(3, 5, 7))


class _DefaultCorrelators:
    """The shared ``sthc_physical`` / ``sthc_ideal`` correlators, one per
    (impl, device), built on first use.  Sharing them keeps the engine's
    grating cache warm across ``conv_layer`` calls, so evaluating many
    batches with the same kernels records the medium once per device (the
    paper's dataflow).  Built lazily: an STHC is bound to a device, and
    importing this module must not need a card."""

    PIPELINES = {"sthc_physical": fidelity.physical, "sthc_ideal": fidelity.ideal}

    def __init__(self):
        self._lock = threading.Lock()
        self._sthc: dict[tuple[str, str], STHC] = {}  # guarded-by: _lock

    def get(self, impl: str, device: torch.device) -> STHC:
        key = (impl, str(device))
        with self._lock:
            sthc = self._sthc.get(key)
            if sthc is None:
                sthc = STHC(STHCConfig(fidelity=self.PIPELINES[impl](), device=key[1]))
                self._sthc[key] = sthc
            return sthc


_DEFAULT_STHC = _DefaultCorrelators()


def _sthc_required(sthc: STHC | None) -> STHC:
    if sthc is None:
        raise ValueError(
            "impl='sthc' requires an explicit STHC correlator (pass "
            "sthc=STHC(STHCConfig(fidelity=...)) with the pipeline to "
            "evaluate)"
        )
    return sthc


def clips_to_device(params: HybridCNN, x) -> Tensor:
    """Clips as a tensor on the parameters' device and in their dtype
    (:func:`~repro_torch.core.engine.stage_clips`)."""
    return stage_clips(x, params.conv_w.device, params.conv_w.dtype)


def conv_layer(
    params: HybridCNN,
    x,
    cfg: HybridConfig,
    impl: str = "digital",
    sthc: STHC | None = None,
) -> Tensor:
    """The (optionally optical) 3-D conv layer, pre-activation."""
    w = params.conv_w
    x = clips_to_device(params, x)
    if impl == "digital":
        y = conv3d_ops.conv3d(x, w)
    elif impl == "spectral":
        y = spectral_conv.correlate3d_fft(x, w, mode="valid")
    elif impl == "sthc":
        y = _sthc_required(sthc)(w, x)
    elif impl in _DefaultCorrelators.PIPELINES:
        y = (sthc or _DEFAULT_STHC.get(impl, x.device))(w, x)
    else:
        raise ValueError(f"unknown conv impl {impl!r}")
    return y + params.conv_b[None, :, None, None, None]


def conv_layer_stream(
    params: HybridCNN,
    x,
    cfg: HybridConfig,
    impl: str = "sthc_physical",
    block_t: int | None = None,
    sthc: STHC | None = None,
) -> Tensor:
    """Long-clip conv layer: T may exceed ``cfg.frames`` arbitrarily.

    STHC backends stream through the engine's coherence-window
    (overlap-save) path; ``'digital'`` is the one-shot direct correlation
    (kernel B4 on the card) the streaming output is tested against.
    ``block_t`` is the coherence window T2 in frames (default:
    ``cfg.frames``)."""
    w = params.conv_w
    x = clips_to_device(params, x)
    # None (not falsy 0) is the default sentinel: an explicit invalid
    # block_t must reach stream_plan's validation, not be remapped
    bt = cfg.frames if block_t is None else int(block_t)
    if impl == "digital":
        y = conv3d_ops.conv3d(x, w)
    elif impl == "spectral":
        # exact ideal path, matching conv_layer's pure-FFT 'spectral': a
        # caller-supplied sthc (possibly physical) is deliberately ignored
        # here — pass impl='sthc_*' to stream through it
        y = _DEFAULT_STHC.get("sthc_ideal", x.device).correlate_stream(w, x, bt)
    elif impl == "sthc":
        y = _sthc_required(sthc).correlate_stream(w, x, bt)
    elif impl in _DefaultCorrelators.PIPELINES:
        y = (sthc or _DEFAULT_STHC.get(impl, x.device)).correlate_stream(w, x, bt)
    else:
        raise ValueError(f"unknown conv impl {impl!r}")
    return y + params.conv_b[None, :, None, None, None]


def head(params: HybridCNN, y: Tensor, cfg: HybridConfig) -> Tensor:
    """The digital layers after the biased conv output: ReLU, max-pool,
    flatten, FC, ReLU, FC → logits (B, num_classes)."""
    y = max_pool3d(F.relu(y), cfg.pool_window)
    y = y.reshape(y.shape[0], -1)
    y = F.relu(y @ params.fc1_w + params.fc1_b[None, :])
    return y @ params.fc2_w + params.fc2_b[None, :]


def forward(
    params: HybridCNN,
    x,
    cfg: HybridConfig,
    impl: str = "digital",
    sthc: STHC | None = None,
) -> Tensor:
    """Full hybrid forward pass → logits (B, num_classes)."""
    return head(params, conv_layer(params, x, cfg, impl=impl, sthc=sthc), cfg)


def loss_fn(
    params: HybridCNN, batch: dict, cfg: HybridConfig, impl: str = "digital"
) -> tuple[Tensor, dict[str, Tensor]]:
    """Cross-entropy loss (the paper trains with Adam + cross-entropy) and
    accuracy of a batch ``{"video", "label"}``; the loss carries the graph
    back to the parameters."""
    logits = forward(params, batch["video"], cfg, impl=impl)
    labels = as_tensor(batch["label"], logits.device, torch.long)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.take_along_dim(logp, labels[:, None], dim=1))
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return loss, {"loss": loss, "accuracy": acc}


@torch.no_grad()
def predict(
    params: HybridCNN,
    x,
    cfg: HybridConfig,
    impl: str = "sthc_physical",
    sthc: STHC | None = None,
) -> Tensor:
    """Inference-time class prediction with the chosen conv backend."""
    return torch.argmax(forward(params, x, cfg, impl=impl, sthc=sthc), dim=-1)
