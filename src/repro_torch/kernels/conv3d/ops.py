"""Public direct-correlation op (port of ``repro.kernels.conv3d.ops``).

``conv3d`` routes by the tensor's device: a CUDA tensor launches the
hand-written kernel B4 of ``kernel.py`` (or raises), a CPU tensor runs
its plain version, :func:`ref.conv3d_ref`, and a ``meta`` tensor gets
an output of the right shape and dtype on ``meta`` and no arithmetic
(the dry run's route).  There is no fallback from one route to the
other.  It is a ``torch.autograd.Function`` whose
backward recomputes the gradient through the plain version (autograd of
``F.conv3d`` in full float32, TF32 off), as the flash op's does; there
is no backward kernel, and the reference has none either (its digital
route is a ``lax.conv`` with XLA's gradient).  Under
``launch.op_analysis.OpCounter`` the forward counts as one op,
``conv3d``, by its own formula on every route, and the backward's ops
under the bucket ``conv3d_bwd(plain)``.
"""

from __future__ import annotations

import torch

from repro_torch.core.spectral_conv import full_precision
from repro_torch.kernels.conv3d import kernel as _kernel
from repro_torch.kernels.conv3d import ref as _ref
from repro_torch.launch import op_analysis

Tensor = torch.Tensor


@op_analysis.counted_kernel(
    "conv3d", lambda x, w: dict(x_shape=tuple(x.shape), w_shape=tuple(w.shape), dtype=x.dtype)
)
def _forward(x: Tensor, w: Tensor) -> Tensor:
    if x.device.type == "cuda":
        return _kernel.conv3d_cuda(x.contiguous(), w.contiguous())
    if x.device.type == "cpu":
        return _ref.conv3d_ref(x, w)
    if x.device.type == "meta":
        B, _, H, W, T = x.shape
        O, _, kh, kw, kt = w.shape
        return x.new_empty((B, O, H - kh + 1, W - kw + 1, T - kt + 1))
    raise ValueError(f"conv3d has no kernel for device {x.device}")


class _Conv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need) for t, need in zip((x, w), ctx.needs_input_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad(), full_precision(), op_analysis.bucket("conv3d_bwd(plain)"):
            grads = iter(torch.autograd.grad(_ref.conv3d_ref(*leaves), wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


def conv3d(x: Tensor, w: Tensor) -> Tensor:
    """Direct valid 3-D correlation.

    x: (B, C, H, W, T), w: (O, C, kh, kw, kt) → (B, O, OH, OW, OT).  The
    reference's ``block_oh`` / ``block_ot`` TPU tiles are not taken: the
    kernel chooses its own tile (``kernel.plan``)."""
    return _Conv3d.apply(x, w)


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
