"""Optical front-end models for the STHC (port of ``repro.core.optics``).

- the spatial light modulator (SLM): non-negative, quantized intensity
  patterns (signed kernels are split upstream by
  :mod:`repro_torch.core.pseudo_negative`);
- the Fourier lens: an exact 2-D spatial Fourier transform;
- the recording pulse: a small circular aperture whose spatial FT
  approximates a plane wave, and whose short duration gives a temporal
  spectrum wider than the video's.

The quantizer uses a straight-through estimator, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SLMConfig:
    """Physical parameters of the spatial light modulator.

    Attributes:
      bits: grey-level bit depth.
      frame_rate_hz: full-frame update rate (1666 fps commercial SLM;
        125 000 fps when frames stream from a holographic memory disc).
      fill_factor: active-area fraction (a global amplitude scale).
    """

    bits: int = 8
    frame_rate_hz: float = 1666.0
    fill_factor: float = 0.95


def quantize_unit(x: Tensor, bits: int) -> Tensor:
    """Uniformly quantize values in [0, 1] to ``2**bits`` levels.

    Straight-through estimator: the value of the quantized signal, the
    gradient of the clipped one.  Computed exactly as the reference's
    ``xc + stop_gradient(q - xc)`` so the forward values agree bit for
    bit (``torch.round`` rounds half to even, like ``jnp.round``).
    """
    if bits <= 0:
        return x
    levels = float(2**bits - 1)
    xc = torch.clamp(x, 0.0, 1.0)
    q = torch.round(xc * levels) / levels
    return xc + (q - xc).detach()


def quantize_signed(x: Tensor, bits: int) -> Tensor:
    """Sign-preserving quantization of values in [-1, 1]: ``2**bits − 1``
    magnitude levels per sign, zero mapped exactly to zero (the
    bipolar-SLM idealization an ablation without ± encoding needs)."""
    if bits <= 0:
        return x
    return torch.sign(x) * quantize_unit(torch.abs(x), bits)


def slm_encode(frames: Tensor, cfg: SLMConfig) -> tuple[Tensor, Tensor]:
    """Encode frames for the SLM: clamp non-negative, scale per leading
    example by the max over (H, W, T), quantize at ``cfg.bits``.

    Returns ``(encoded, scale)`` with ``encoded * scale`` the physical
    field amplitude presented to the optics."""
    frames = torch.clamp(frames, min=0.0)
    reduce_axes = tuple(range(frames.ndim - 3, frames.ndim))
    scale = torch.amax(frames, dim=reduce_axes, keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    unit = frames / scale
    encoded = quantize_unit(unit, cfg.bits) * cfg.fill_factor
    return encoded, scale / cfg.fill_factor


def lens_ft(field: Tensor, axes: Sequence[int] = (-2, -1)) -> Tensor:
    """Ideal thin-lens spatial Fourier transform (orthonormal)."""
    return torch.fft.fftn(field, dim=tuple(axes), norm="ortho")


def lens_ift(field: Tensor, axes: Sequence[int] = (-2, -1)) -> Tensor:
    """Inverse lens transform (the second lens of the 4-f system)."""
    return torch.fft.ifftn(field, dim=tuple(axes), norm="ortho")


def aperture_mask(
    shape_hw: tuple[int, int], radius_frac: float, device=None
) -> Tensor:
    """Circular aperture (low-pass) mask in the Fourier plane;
    ``radius_frac`` is the passband radius as a fraction of Nyquist."""
    h, w = shape_hw
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.fftfreq(w, device=device)[None, :]
    r = torch.sqrt((fy / 0.5) ** 2 + (fx / 0.5) ** 2)
    return (r <= 2.0 * radius_frac).to(torch.float32)


def recording_pulse_spatial(
    shape_hw: tuple[int, int], radius_px: float, device=None
) -> Tensor:
    """The recording pulse as displayed on the SLM: a small filled
    circle, normalized to unit energy."""
    h, w = shape_hw
    yy = torch.arange(h, device=device)[:, None] - (h - 1) / 2.0
    xx = torch.arange(w, device=device)[None, :] - (w - 1) / 2.0
    disc = ((yy**2 + xx**2) <= radius_px**2).to(torch.float32)
    return disc / torch.sqrt(torch.clamp(torch.sum(disc**2), min=1.0))


def recording_pulse_spectrum(
    shape_hw: tuple[int, int], radius_px: float = 1.5, device=None
) -> Tensor:
    """Spatial spectrum of the recording pulse at the atomic plane,
    normalized to unit peak (the physical mode's residual
    non-uniformity)."""
    pulse = recording_pulse_spatial(shape_hw, radius_px, device)
    spec = torch.abs(torch.fft.fft2(pulse))
    return spec / torch.clamp(torch.amax(spec), min=1e-12)


def temporal_pulse_spectrum(
    n_t: int, duration_frames: float = 0.25, device=None
) -> Tensor:
    """Temporal spectrum of the short recording pulse: a Gaussian with
    ``sigma_t = duration`` in frame units, normalized to unit peak."""
    f = torch.fft.fftfreq(n_t, device=device)
    sigma_f = 1.0 / (2.0 * math.pi * max(duration_frames, 1e-6))
    spec = torch.exp(-0.5 * (f / sigma_f) ** 2)
    return spec / torch.clamp(torch.amax(spec), min=1e-12)
