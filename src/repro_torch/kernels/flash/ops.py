"""Public flash-attention op (port of ``repro.kernels.flash.ops``).

``flash_attention`` routes by the tensor's device: a CUDA tensor
launches the hand-written forward kernel of ``kernel.py`` (or raises),
a CPU tensor runs its plain version, :func:`ref.flash_ref`.  There is no
fallback from one route to the other.  As the reference's
``custom_vjp``, it is a ``torch.autograd.Function`` whose backward
recomputes the gradient through the plain version (the same
online-softmax arithmetic); there is no backward kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash import kernel as _kernel
from repro_torch.kernels.flash import ref as _ref

Tensor = torch.Tensor


def _forward(q: Tensor, k: Tensor, v: Tensor, causal: bool, softmax_scale) -> Tensor:
    if q.device.type == "cuda":
        return _kernel.flash_fwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, softmax_scale
        )
    if q.device.type == "cpu":
        return _ref.flash_ref(q, k, v, causal=causal, softmax_scale=softmax_scale)
    raise ValueError(f"flash_attention has no kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, softmax_scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.softmax_scale = causal, softmax_scale
        return _forward(q, k, v, causal, softmax_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _ref.flash_ref(
                *leaves, causal=ctx.causal, softmax_scale=ctx.softmax_scale
            )
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)


def flash_attention(
    q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
    softmax_scale: float | None = None,
) -> Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, G, D), G | H → (B, Sq, H, D)."""
    return _FlashAttention.apply(q, k, v, causal, softmax_scale)
