"""Pseudo-negative encoding of signed kernels for intensity-only optics
(port of ``repro.core.pseudo_negative``).

A signed kernel K splits into ``K⁺ = max(K, 0)`` and ``K⁻ = max(−K, 0)``,
run in parallel optical channels and recombined digitally as
``(X ⋆ K⁺) − (X ⋆ K⁻)``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def split(kernel: Tensor) -> tuple[Tensor, Tensor]:
    """Split a signed kernel into (K⁺, K⁻), both non-negative."""
    return torch.clamp(kernel, min=0.0), torch.clamp(-kernel, min=0.0)


def combine(y_plus: Tensor, y_minus: Tensor) -> Tensor:
    """Digital reconstruction of the signed correlation output."""
    return y_plus - y_minus


def interleave_channels(k_plus: Tensor, k_minus: Tensor) -> Tensor:
    """Stack the ± kernels: ``(O, ...)`` → ``(2*O, ...)`` with output o's
    positive channel at ``2*o`` and its negative at ``2*o+1``."""
    stacked = torch.stack([k_plus, k_minus], dim=1)
    return stacked.reshape((-1,) + tuple(k_plus.shape[1:]))


def deinterleave_outputs(y: Tensor, axis: int = 1) -> Tensor:
    """Undo :func:`interleave_channels` on outputs and combine."""
    y = torch.movedim(y, axis, 0)
    o2 = y.shape[0]
    y = y.reshape((o2 // 2, 2) + tuple(y.shape[1:]))
    return torch.movedim(y[:, 0] - y[:, 1], 0, axis)
