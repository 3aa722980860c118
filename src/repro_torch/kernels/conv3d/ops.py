"""Public direct-correlation op (port of ``repro.kernels.conv3d.ops``).

``conv3d`` routes by the tensor's device: a CUDA tensor launches the
hand-written kernel B4 of ``kernel.py`` (or raises), a CPU tensor runs
its plain version, :func:`ref.conv3d_ref`.  There is no fallback from
one route to the other.  B4 has no backward: on the card it refuses
inputs that require a gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv3d import kernel as _kernel
from repro_torch.kernels.conv3d import ref as _ref

Tensor = torch.Tensor


def conv3d(x: Tensor, w: Tensor) -> Tensor:
    """Direct valid 3-D correlation.

    x: (B, C, H, W, T), w: (O, C, kh, kw, kt) → (B, O, OH, OW, OT).  The
    reference's ``block_oh`` / ``block_ot`` TPU tiles are not taken: the
    kernel chooses its own tile (``kernel.plan``)."""
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise ValueError("kernel B4 has no backward; call conv3d under torch.no_grad()")
        return _kernel.conv3d_cuda(x.contiguous(), w.contiguous())
    if x.device.type == "cpu":
        return _ref.conv3d_ref(x, w)
    raise ValueError(f"conv3d has no kernel for device {x.device}")


def conv3d_strips(x: Tensor, w: Tensor, strip_h: int = 32) -> Tensor:
    """``conv3d`` per halo strip of ``strip_h`` output rows (each strip
    reads ``strip_h + kh − 1`` input rows), concatenated along H."""
    kh = w.shape[2]
    OH = x.shape[2] - kh + 1
    outs = []
    start = 0
    while start < OH:
        rows = min(strip_h, OH - start)
        outs.append(conv3d(x[:, :, start : start + rows + kh - 1], w))
        start += rows
    return torch.cat(outs, dim=2)
