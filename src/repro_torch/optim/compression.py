"""Gradient compression with error feedback (port of
``repro.optim.compression``).

int8 block-quantized gradients cut a data-parallel all-reduce's bytes 4×
(against float32) at the cost of quantization noise; the error-feedback
residual is kept locally and re-injected at the next step, which keeps
SGD-class convergence (Karimireddy et al., 2019).  The quantizer is
simulated: it returns the dequantized values (the wire format would be
the int8 codes and one scale per block).  ``torch.round``, like
``jnp.round``, rounds half to even, so the codes equal the reference's.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    block: int = 256  # values per quantization block
    enabled: bool = True


CompressionState = dict  # error-feedback residuals, the same names as the grads


def compression_init(params: dict[str, Tensor]) -> CompressionState:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}


def _quantize_codes(g: Tensor, block: int) -> tuple[Tensor, Tensor]:
    """Symmetric int8 block quantization of g flattened: the codes
    (n_blocks, block) in [-127, 127] (as float32) and each block's scale
    (n_blocks, 1); the tail block is zero-padded."""
    flat = g.float().reshape(-1)
    fp = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    scale = torch.amax(torch.abs(fp), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, 1.0)
    return torch.clamp(torch.round(fp / scale), -127, 127), scale


def _quantize_leaf(g: Tensor, block: int) -> Tensor:
    """g quantized to int8 per block of ``block`` values and dequantized."""
    q, scale = _quantize_codes(g, block)
    return (q * scale).reshape(-1)[: g.numel()].reshape(g.shape)


def compress_gradients(
    grads: dict[str, Tensor], err: CompressionState, block: int = 256
) -> tuple[dict[str, Tensor], CompressionState]:
    """Error-feedback int8 compression: returns (compressed, new_err).

    compressed = Q(g + err);  new_err = (g + err) − compressed."""
    comp, new_err = {}, {}
    for name, g in grads.items():
        corrected = g.float() + err[name]
        q = _quantize_leaf(corrected, block)
        comp[name] = q.to(g.dtype)
        new_err[name] = corrected - q
    return comp, new_err
