"""The benchmark's fixed arithmetic: the H100's published peaks, the
operation and byte counts of the spectral correlator, and the
overlap-save window plan.

These are frozen copies, kept here so that a later change to the program
cannot move the yardstick it is measured with:

* ``HBM_BW`` / ``PEAK_F32``: ``repro_torch/launch/roofline.py`` (NVIDIA's
  data sheet, H100 SXM, dense: 3.35e12 B/s, 67e12 float32 FLOP/s outside
  the tensor cores);
* ``spectral_mac_cost`` / ``grouped_mac_bytes``:
  ``repro_torch/launch/op_analysis.py`` ``kernel_cost`` for
  ``spectral_mac`` (B1) and ``spectral_mac_grouped`` (B2);
* ``fft_flops``: ``repro_torch/core/throughput.py``
  ``ConvWorkload.fft_flops``, with ``next_fast_len`` / ``fft_shape_for``
  from ``repro_torch/core/spectral_conv.py``;
* ``stream_plan``: ``repro_torch/core/spectral_conv.py`` ``stream_plan``.

``test_portbench_harness.py`` holds each copy equal to the program's at
every cell's shapes.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math

HBM_BW = 3.35e12  # B/s
PEAK_F32 = 67e12  # FLOP/s, float32 outside the tensor cores


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n."""
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            x = p35
            while x < n:
                x *= 2
            if x < best:
                best = x
            p35 *= 3
        p5 *= 5
    return best


def fft_shape_for(sig_shape, ker_shape) -> tuple[int, ...]:
    """FFT grid of a linear correlation: N + K - 1, rounded up to 5-smooth."""
    return tuple(next_fast_len(int(n) + int(k) - 1) for n, k in zip(sig_shape, ker_shape))


def fft_flops(height, width, frames, in_channels, out_channels, k_h, k_w, k_t) -> int:
    """FLOPs of the spectral path for one clip: 5 N log2 N per complex
    3-D FFT (forward per input channel, inverse per output channel) and 8
    per complex MAC of the channel contraction."""
    fh, fw, ft = fft_shape_for((height, width, frames), (k_h, k_w, k_t))
    n = fh * fw * ft

    def fft3(n_points: int) -> float:
        return 5.0 * n_points * math.log2(max(n_points, 2))

    fwd = in_channels * fft3(n)
    mac = 8.0 * in_channels * out_channels * (fh * fw * (ft // 2 + 1))
    inv = out_channels * fft3(n)
    return int(fwd + mac + inv)


def spectral_bins(height, width, frames, k_h, k_w, k_t) -> int:
    """Complex bins F of one real 3-D spectrum on the correlation's grid."""
    fh, fw, ft = fft_shape_for((height, width, frames), (k_h, k_w, k_t))
    return fh * fw * (ft // 2 + 1)


def spectral_mac_cost(B: int, O: int, C: int, F: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one B1 call: x (B, C, F), grating (O, C, F) and y
    (B, O, F), complex64, each read or written once."""
    return 8 * B * O * C * F, (B * C * F + O * C * F + B * O * F) * 8


def grouped_mac_bytes(rows: int, arena_rows: int, C: int, F: int, n_out: int, itemsize: int) -> int:
    """Bytes of a B2 product: ``rows`` spectra (C, F) complex64 read once,
    ``arena_rows`` grating rows read once as two planes of ``itemsize``,
    ``rows`` outputs (n_out, F) complex64 written once."""
    return rows * C * F * 8 + 2 * arena_rows * C * F * itemsize + rows * n_out * F * 8


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    block_t: int
    step: int
    n_valid: int
    n_blocks: int
    chunk: int
    n_padded: int
    pad_t: int


def stream_plan(T: int, kt: int, block_t: int, chunk_windows: int | None = None) -> StreamPlan:
    """The overlap-save pass over a T-frame stream in windows of block_t."""
    T, kt, block_t = int(T), int(kt), int(block_t)
    if block_t <= kt - 1:
        raise ValueError(f"block_t ({block_t}) must exceed kt-1 ({kt - 1})")
    if T < kt:
        raise ValueError(f"stream length ({T}) is shorter than kt ({kt})")
    step = block_t - (kt - 1)
    n_valid = T - kt + 1
    n_blocks = -(-n_valid // step)
    chunk = max(1, min(int(chunk_windows or 1), n_blocks))
    n_padded = -(-n_blocks // chunk) * chunk
    pad_t = max((n_padded - 1) * step + block_t - T, 0)
    return StreamPlan(block_t, step, n_valid, n_blocks, chunk, n_padded, pad_t)
