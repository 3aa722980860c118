"""Atomic-medium model for the STHC (port of ``repro.core.atomic``).

IHB bandwidth band-limits the temporal frequencies the atoms can
store; the coherence lifetime T2 gives an echo-efficiency factor and a
per-frame decay of the stored reference (modelled as time-domain tap
weights); the photon echo is emitted at ``T_Q + T_R − T_P``.  All
envelopes are unit-peak, so the ideal pipeline (envelope ≡ 1) is the
exact FFT correlator.
"""

from __future__ import annotations

import dataclasses
import math

import torch

Tensor = torch.Tensor

IHB_BANDWIDTH_HZ_DEFAULT = 100e6  # 100 MHz inhomogeneous broadening
IHB_RAD_PER_S_DEFAULT = 6.28e8  # = 2*pi * 100 MHz
FRAME_LOAD_TIME_S = 1.0 / IHB_RAD_PER_S_DEFAULT  # ~1.6 ns theoretical floor


@dataclasses.dataclass(frozen=True)
class AtomicConfig:
    """Parameters of the cold-atom storage medium.

    Attributes:
      ihb_bandwidth_hz: full inhomogeneous broadening (Hz).
      t2_s: ground-state coherence lifetime (seconds).
      frame_time_s: time allotted per video frame at the atoms.
      ihb_profile: 'gaussian' | 'lorentzian' | 'flat' spectral coverage.
      coverage: IHB width over the video's temporal bandwidth.
    """

    ihb_bandwidth_hz: float = IHB_BANDWIDTH_HZ_DEFAULT
    t2_s: float = 1e-3
    frame_time_s: float = FRAME_LOAD_TIME_S
    ihb_profile: str = "gaussian"
    coverage: float = 2.0

    @property
    def window_frames(self) -> int:
        """Max frames storable within one coherence window (T2 cap)."""
        return max(int(self.t2_s / self.frame_time_s), 1)


def ihb_envelope(n_t: int, cfg: AtomicConfig, device=None) -> Tensor:
    """Unit-peak diffraction-efficiency envelope of the IHB'd ensemble
    over the ``n_t`` normalized temporal frequencies (±0.5 cycles/frame);
    the IHB width is ``coverage`` × the signal bandwidth."""
    f = torch.fft.fftfreq(n_t, device=device)
    half = cfg.coverage / 2.0
    if cfg.ihb_profile == "flat":
        env = (torch.abs(f) <= half).to(torch.float32)
    elif cfg.ihb_profile == "lorentzian":
        env = 1.0 / (1.0 + (f / half) ** 2)
    else:  # gaussian (default): FWHM = coverage (normalized)
        sigma = cfg.coverage / (2.0 * math.sqrt(2.0 * math.log(2.0)))
        env = torch.exp(-0.5 * (f / sigma) ** 2)
    return env / torch.clamp(torch.amax(env), min=1e-12)


def t2_tap_weights(
    kt: int, cfg: AtomicConfig, storage_interval_s: float = 0.0, device=None
) -> Tensor:
    """Per-frame decay ``exp(-(Δt + (kt-1-τ)·frame_time) / T2)`` of the
    kt stored reference frames at readout."""
    tau = torch.arange(kt, device=device, dtype=torch.float32)
    dt = storage_interval_s + (kt - 1 - tau) * cfg.frame_time_s
    return torch.exp(-dt / cfg.t2_s)


def echo_efficiency(cfg: AtomicConfig, storage_interval_s: float, device=None) -> Tensor:
    """Overall echo-amplitude factor exp(-Δt / T2) for a storage interval."""
    dt = torch.as_tensor(storage_interval_s, dtype=torch.float32, device=device)
    return torch.exp(-dt / cfg.t2_s)


def photon_echo_transfer(n_t: int, cfg: AtomicConfig, device=None) -> Tensor:
    """Temporal transfer function H(f_t) of the medium: the IHB coverage
    envelope (T2 decay acts in the time domain, see
    :func:`t2_tap_weights`)."""
    return ihb_envelope(n_t, cfg, device)

