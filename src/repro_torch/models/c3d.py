"""C3D on the port: the digital 3-D CNN of Tran et al. (ICCV 2015) that the
paper's correlator is set against (``core/throughput.py``), at its
published widths (``configs/c3d_sports1m.py``).

Every convolution goes through :func:`repro_torch.kernels.conv3d.ops.conv3d`
with its one-voxel zero border, bias and ReLU: on the card kernel B4's
``igemm`` route (``csrc/conv3d_igemm.cu``, 3xTF32 on the tensor cores),
which reads the border itself; on the CPU the plain version.  Between
layers the activations stay channels-last, (B, H, W, T, C), the layout
that route reads and writes; the pools are ``amax`` over a view of
them; fc6–fc8 are float32 GEMMs (TF32 off).  The parameters are those
of :mod:`repro_torch.models.c3d_ref` under the same names and layouts:
each convolution's weight (O, C, kT, kH, kW) and bias (O,), each fully
connected layer's weight (in, out), applied as ``y @ W``, and bias.
Clips are (B, C, H, W, T), the port's layout of a clip.

:func:`trunk` records a span per layer (``c3d.conv1a`` ... ``c3d.conv5b``,
``c3d.pool1`` ... ``c3d.pool5``); the server wraps it in
``classify.conv`` and :func:`head` in ``classify.head``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device, tracing
from repro_torch.configs.c3d_sports1m import KERNEL, C3DConfig
from repro_torch.core.spectral_conv import full_precision
from repro_torch.kernels.conv3d import ops as conv3d_ops

Tensor = torch.Tensor


def param_shapes(cfg: C3DConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, in the order they are drawn."""
    k = KERNEL
    out: dict[str, tuple[int, ...]] = {}
    for name, c, o in cfg.convs():
        out[f"{name}_w"] = (o, c, k, k, k)
        out[f"{name}_b"] = (o,)
    for name, a, b in cfg.fcs():
        out[f"{name}_w"] = (a, b)
        out[f"{name}_b"] = (b,)
    return out


class C3D(nn.Module):
    """C3D's parameters (zeros until loaded or initialized), frozen."""

    def __init__(self, cfg: C3DConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        for name, shape in param_shapes(cfg).items():
            t = torch.zeros(shape, dtype=torch.float32, device=device)
            setattr(self, name, nn.Parameter(t, requires_grad=False))

    def forward(self, clips: Tensor) -> Tensor:
        return forward(self, clips)


@torch.no_grad()
def init_params(cfg: C3DConfig, generator: torch.Generator | None = None, device=None,
                bias_std: float = 0.01) -> C3D:
    """He-scaled normal weights (fan-in: C·27 for a convolution, the inputs
    of a fully connected layer) and normal biases of ``bias_std``, drawn
    in :func:`param_shapes`' order from ``generator`` (on ``device``)."""
    model = C3D(cfg, device)
    for name, p in model.named_parameters():
        p.copy_(torch.randn(p.shape, generator=generator, dtype=p.dtype, device=p.device))
        fan = p.shape[0] if p.ndim == 2 else p[0].numel()  # (in, out) or (O, C, k, k, k)
        p.mul_((2.0 / fan) ** 0.5 if name.endswith("_w") else bias_std)
    return model


def max_pool_cl(x: Tensor, window: tuple[int, int, int]) -> Tensor:
    """Max pool of channels-last x (B, H, W, T, C) over non-overlapping
    (rows, columns, frames) windows, a ragged last window kept (Caffe's
    and ``F.max_pool3d(ceil_mode=True)``'s rounding up)."""
    B, H, W, T, C = x.shape
    pad = [-n % p for n, p in zip((H, W, T), window)]
    if any(pad):
        x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]), value=float("-inf"))
    ph, pw, pt = window
    Hp, Wp, Tp = H + pad[0], W + pad[1], T + pad[2]
    return x.reshape(B, Hp // ph, ph, Wp // pw, pw, Tp // pt, pt, C).amax(dim=(2, 4, 6))


def trunk(params: C3D, clips: Tensor) -> Tensor:
    """The eight convolutions and five pools: clips (B, C, H, W, T) on the
    parameters' device → features (B, cfg.features), flattened in Caffe's
    (C, T, H, W) order."""
    cfg = params.cfg
    h = clips.permute(0, 2, 3, 4, 1)  # channels-last view (B, H, W, T, C)
    convs = iter(cfg.convs())
    for i, (widths, window) in enumerate(zip(cfg.stages, cfg.pools)):
        for _ in widths:
            name = next(convs)[0]
            with tracing.span(f"c3d.{name}"):
                w = getattr(params, f"{name}_w").permute(0, 1, 3, 4, 2)  # (O, C, kH, kW, kT)
                h = conv3d_ops.conv3d(h, w, pad=KERNEL // 2, bias=getattr(params, f"{name}_b"),
                                      relu=True, channels_last=True)
        with tracing.span(f"c3d.pool{i + 1}"):
            h = max_pool_cl(h, window)
    return h.permute(0, 4, 3, 1, 2).reshape(h.shape[0], -1)


def head(params: C3D, features: Tensor) -> Tensor:
    """fc6, ReLU, fc7, ReLU, fc8 (dropout is identity at inference) in
    float32 → logits (B, num_classes)."""
    fcs = params.cfg.fcs()
    h = features
    with full_precision():
        for k, (name, _, _) in enumerate(fcs):
            h = h @ getattr(params, f"{name}_w") + getattr(params, f"{name}_b")[None, :]
            if k + 1 < len(fcs):
                h = F.relu(h)
    return h


def forward(params: C3D, clips: Tensor) -> Tensor:
    """Logits (B, num_classes) of clips (B, C, H, W, T)."""
    return head(params, trunk(params, clips))
