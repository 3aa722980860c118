"""Throughput / speed-projection model (paper §2, §5, Table-style claims;
port of ``repro.core.throughput``).

The optical conv layer's rate is set by how fast frames can be *loaded*,
not by the correlation itself (which is passive and effectively instant):

  * commercial ultra-high-speed SLM:        1 666 fps
  * holographic memory disc (HMD) loader: 125 000 fps
  * physical floor (IHB bandwidth):       1 / 1.6 ns ≈ 6.2e8 fps

against the digital baselines the paper cites:

  * C3D on NVIDIA K40:          313.9 fps
  * R(2+1)D on RTX 2080 Ti:     350–400 fps

This module reproduces those numbers from first principles where possible
(the IHB floor from the 100 MHz broadening) and tabulates the speedups, as
well as a FLOPs ledger for the paper's conv layer that the roofline /
benchmarks reuse.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import atomic

# Digital baselines quoted by the paper (frames per second).
C3D_K40_FPS = 313.9
R2P1D_2080TI_FPS = 400.0  # upper end of the 350-400 range
SLM_FPS = 1666.0
HMD_FPS = 125_000.0


@dataclasses.dataclass(frozen=True)
class ConvWorkload:
    """The paper's optical conv layer workload (defaults = paper values)."""

    height: int = 60
    width: int = 80
    frames: int = 16
    in_channels: int = 1
    out_channels: int = 9
    k_h: int = 30
    k_w: int = 40
    k_t: int = 8

    @property
    def out_shape(self) -> tuple[int, int, int]:
        return (
            self.height - self.k_h + 1,
            self.width - self.k_w + 1,
            self.frames - self.k_t + 1,
        )

    def direct_macs(self) -> int:
        """MACs for direct (digital) valid correlation."""
        oh, ow, ot = self.out_shape
        taps = self.k_h * self.k_w * self.k_t
        return oh * ow * ot * taps * self.in_channels * self.out_channels

    def fft_flops(self) -> int:
        """FLOPs for the spectral path (per clip): 3-D rFFTs + spectral MAC.

        5 N log2 N per complex FFT length N (standard split-radix count),
        batched over the other two axes; plus 8 FLOPs per complex MAC in
        the channel contraction; plus the inverse FFT per output channel.
        """
        import math

        from repro_torch.core.spectral_conv import fft_shape_for

        fh, fw, ft = fft_shape_for(
            (self.height, self.width, self.frames), (self.k_h, self.k_w, self.k_t)
        )
        n = fh * fw * ft

        def fft3(n_points: int) -> float:
            return 5.0 * n_points * math.log2(max(n_points, 2))

        fwd = self.in_channels * fft3(n)
        mac = 8.0 * self.in_channels * self.out_channels * (fh * fw * (ft // 2 + 1))
        inv = self.out_channels * fft3(n)
        return int(fwd + mac + inv)

    def spectral_advantage(self) -> float:
        """Direct-MACs / spectral-FLOPs — ~the optical system's edge."""
        return (2.0 * self.direct_macs()) / max(self.fft_flops(), 1)


def ihb_floor_fps(cfg: atomic.AtomicConfig | None = None) -> float:
    """Frame rate at the physical loading floor set by the IHB bandwidth."""
    cfg = cfg or atomic.AtomicConfig()
    return 1.0 / (1.0 / (2.0 * 3.141592653589793 * cfg.ihb_bandwidth_hz))


def throughput_table() -> list[dict]:
    """The paper's speed-comparison table, one row per system."""
    rows = [
        {"system": "C3D (NVIDIA K40, digital)", "fps": C3D_K40_FPS},
        {"system": "R(2+1)D (RTX 2080 Ti, digital)", "fps": R2P1D_2080TI_FPS},
        {"system": "STHC + high-speed SLM", "fps": SLM_FPS},
        {"system": "STHC + HMD loader", "fps": HMD_FPS},
        {"system": "STHC physical floor (100 MHz IHB)", "fps": ihb_floor_fps()},
    ]
    base = R2P1D_2080TI_FPS
    for r in rows:
        r["speedup_vs_R(2+1)D"] = r["fps"] / base
    return rows
