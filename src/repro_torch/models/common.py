"""Shared building blocks of the port's models (the part of
``repro.models.common`` that Mamba-2 uses).

Parameters are initialised with an explicit ``torch.Generator``; the
numbers differ from ``jax.random``'s for the same seed, so parity tests
carry the reference's weights across (``repro_torch.interop``) rather
than re-seeding.  Norm statistics stay float32 and cast back to the
input's dtype, as in the reference.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def dense_init(
    generator: torch.Generator,
    shape: tuple[int, ...],
    dtype: torch.dtype,
    scale: float | None = None,
) -> Tensor:
    """Truncated-normal init on [−2, 2] (std = 1/sqrt(fan_in) unless
    given), drawn in float32 on the generator's device, cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    # inverse-CDF sampling of the standard normal restricted to [−2, 2]
    lo, hi = (1.0 + math.erf(-math.sqrt(2.0))) / 2, (1.0 + math.erf(math.sqrt(2.0))) / 2
    u = torch.rand(shape, generator=generator, device=generator.device)
    w = torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0) * math.sqrt(2.0)
    return (w.clamp(-2.0, 2.0) * std).to(dtype)


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
