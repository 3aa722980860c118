"""Spectral (Fourier-domain) 3-D correlation (port of
``repro.core.spectral_conv``).

    record:   G[o, c, f]  = conj( FFT3(K[o, c]) )               (once)
    query:    Ŷ[b, o, f]  = Σ_c  FFT3(X[b, c])[f] · G[o, c, f]   (per clip)
    readout:  Y[b, o]     = IFFT3(Ŷ[b, o])[valid region]

Signals are real (``rfftn`` over the last three axes H, W, T);
"correlation" is the CNN forward operator ``Y[i] = Σ_m K[m] X[i+m]``.
FFTs are library calls (``torch.fft``, cuFFT on the card), as ``jnp.fft``
is in the reference.  The overlap-save windowing arithmetic
(:class:`StreamPlan`, :class:`StreamCursor`, :func:`stream_cursor`) is
pure integer code and equals the reference's field by field.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_FFT_AXES = (-3, -2, -1)


@contextlib.contextmanager
def full_precision():
    """Run float32 matmuls and convolutions in full float32: TF32 off for
    both cuBLAS and cuDNN (cuDNN's default is on), restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer ≥ n — fast FFT sizes."""
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


def fft_shape_for(
    sig_shape: Sequence[int], ker_shape: Sequence[int], fast: bool = True
) -> tuple[int, ...]:
    """FFT grid for a linear (non-circular) correlation: ≥ N + K − 1."""
    full = [int(n) + int(k) - 1 for n, k in zip(sig_shape, ker_shape)]
    if fast:
        full = [next_fast_len(n) for n in full]
    return tuple(full)


def valid_shape(sig_shape: Sequence[int], ker_shape: Sequence[int]) -> tuple[int, ...]:
    return tuple(int(n) - int(k) + 1 for n, k in zip(sig_shape, ker_shape))


def make_grating(
    kernels: Tensor,
    fft_shape: tuple[int, int, int],
    spatial_transfer: Tensor | None = None,
) -> Tensor:
    """Record kernels (O, C, kh, kw, kt) into the complex grating
    ``conj(rfftn(K))`` of shape (O, C, FH, FW, FT//2+1).  Temporal
    medium envelopes are applied by the engine on the kernel's own
    kt-point grid, not here."""
    grating = torch.conj(torch.fft.rfftn(kernels, s=fft_shape, dim=_FFT_AXES))
    grating = grating.resolve_conj()
    if spatial_transfer is not None:
        grating = grating * spatial_transfer[..., :, :, None]
    return grating


def query_grating(
    x: Tensor,
    grating: Tensor,
    fft_shape: tuple[int, int, int],
    out_shape: tuple[int, int, int],
) -> Tensor:
    """Diffract query clips (B, C, H, W, T) off a grating — the plain
    einsum path (the counterpart of the reference's dense XLA path).
    Returns (B, O, *out_shape)."""
    xhat = torch.fft.rfftn(x, s=fft_shape, dim=_FFT_AXES)
    with full_precision():
        yhat = torch.einsum("bcxyz,ocxyz->boxyz", xhat, grating)
    y = torch.fft.irfftn(yhat, s=fft_shape, dim=_FFT_AXES)
    return y[..., : out_shape[0], : out_shape[1], : out_shape[2]]


def correlate3d_fft(
    x: Tensor,
    kernels: Tensor,
    mode: str = "valid",
    spatial_transfer: Tensor | None = None,
) -> Tensor:
    """FFT-based multi-channel 3-D correlation, x (B, C, H, W, T) with
    kernels (O, C, kh, kw, kt); mode 'valid' | 'same' | 'full'."""
    sig = tuple(x.shape[-3:])
    ker = tuple(kernels.shape[-3:])
    fft_shape = fft_shape_for(sig, ker)
    grating = make_grating(kernels, fft_shape, spatial_transfer)
    full = tuple(n + k - 1 for n, k in zip(sig, ker))
    if mode == "valid":
        return query_grating(x, grating, fft_shape, valid_shape(sig, ker))
    if mode not in ("full", "same"):
        raise ValueError(f"unknown mode {mode!r}")
    xhat = torch.fft.rfftn(x, s=fft_shape, dim=_FFT_AXES)
    with full_precision():
        yhat = torch.einsum("bcxyz,ocxyz->boxyz", xhat, grating)
    y = torch.fft.irfftn(yhat, s=fft_shape, dim=_FFT_AXES)
    # full / same need the negative lags, which wrap circularly: roll by K-1
    y = torch.roll(y, tuple(k - 1 for k in ker), dims=_FFT_AXES)
    y = y[..., : full[0], : full[1], : full[2]]
    if mode == "full":
        return y
    starts = tuple(k // 2 for k in ker)  # XLA SAME crop in full indexing
    return y[
        ...,
        starts[0] : starts[0] + sig[0],
        starts[1] : starts[1] + sig[1],
        starts[2] : starts[2] + sig[2],
    ]


def direct_correlate3d(x: Tensor, kernels: Tensor, mode: str = "valid") -> Tensor:
    """Direct 3-D correlation through ``conv3d`` (cross-correlation, no
    kernel flip) in full float32 — the test oracle.  x: (B, C, H, W, T);
    kernels (O, C, kh, kw, kt)."""
    ks = kernels.shape[-3:]
    if mode == "valid":
        pads = [(0, 0)] * 3
    elif mode == "same":  # XLA SAME: (k-1)//2 low, k//2 high
        pads = [((k - 1) // 2, k // 2) for k in ks]
    elif mode == "full":
        pads = [(k - 1, k - 1) for k in ks]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        x = F.pad(x, flat)
    with full_precision():
        return F.conv3d(x, kernels)


# ---------------------------------------------------------------------------
# Overlap-save windowing math (paper Fig. 1C as arithmetic)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Window arithmetic of one overlap-save pass (all Python ints).

    Attributes:
      block_t: frames per coherence window (T2).
      step: valid outputs contributed per window (= block_t − kt + 1).
      n_valid: total valid outputs (= T − kt + 1).
      n_blocks: windows actually required to cover the stream.
      chunk: windows correlated per step as one batch.
      n_padded: n_blocks rounded up to whole chunks.
      pad_t: zero frames appended to the stream tail so every window is
        full length; the surplus outputs are cropped.
    """

    block_t: int
    step: int
    n_valid: int
    n_blocks: int
    chunk: int
    n_padded: int
    pad_t: int


def stream_plan(
    T: int, kt: int, block_t: int, chunk_windows: int | None = None
) -> StreamPlan:
    """Plan an overlap-save pass over a T-frame stream (pure arithmetic)."""
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


@dataclasses.dataclass(frozen=True)
class StreamSegment:
    """One bounded-buffer slice of an overlap-save pass (pure ints):
    input frames ``[t0, t1)``, ``n_windows`` windows, producing valid
    outputs ``[out_t0, out_t0 + n_valid)``.  Consecutive segments overlap
    by kt − 1 input frames, so chunked streaming equals one-shot."""

    index: int
    t0: int
    t1: int
    frames: int
    n_windows: int
    out_t0: int
    n_valid: int


class StreamCursor:
    """Bounded-memory iteration plan over one overlap-save pass: segments
    of at most ``max_buffer_windows`` windows each, so a stream of any
    length is served at constant peak memory."""

    def __init__(self, plan: StreamPlan, max_buffer_windows: int):
        if max_buffer_windows < 1:
            raise ValueError(
                f"max_buffer_windows must be >= 1, got {max_buffer_windows}"
            )
        self.plan = plan
        self.max_buffer_windows = int(max_buffer_windows)
        kt = plan.block_t - plan.step + 1
        T = plan.n_valid + kt - 1
        segments: list[StreamSegment] = []
        done = 0
        while done < plan.n_blocks:
            n = min(self.max_buffer_windows, plan.n_blocks - done)
            t0 = done * plan.step
            t1 = min(t0 + (n - 1) * plan.step + plan.block_t, T)
            out_t0 = done * plan.step
            n_valid = min(t1 - t0 - kt + 1, plan.n_valid - out_t0)
            segments.append(
                StreamSegment(
                    index=len(segments),
                    t0=t0,
                    t1=t1,
                    frames=t1 - t0,
                    n_windows=n,
                    out_t0=out_t0,
                    n_valid=n_valid,
                )
            )
            done += n
        self.segments = tuple(segments)

    @property
    def peak_buffer_frames(self) -> int:
        """Largest per-segment input buffer — the constant-memory bound."""
        return max(s.frames for s in self.segments)

    def __iter__(self):
        return iter(self.segments)

    def __len__(self) -> int:
        return len(self.segments)


def stream_cursor(
    T: int,
    kt: int,
    block_t: int,
    chunk_windows: int | None = None,
    max_buffer_windows: int | None = None,
) -> StreamCursor:
    """Cursor over a freshly planned overlap-save pass (pure arithmetic).

    ``max_buffer_windows=None`` means one segment spanning the whole
    stream (the unbounded one-shot pass)."""
    plan = stream_plan(T, kt, block_t, chunk_windows)
    if max_buffer_windows is None:
        max_buffer_windows = plan.n_blocks
    return StreamCursor(plan, max_buffer_windows)


def window_starts(plan: StreamPlan) -> Tensor:
    """First-frame indices of every window, grouped (n_outer, chunk)."""
    return (torch.arange(plan.n_padded) * plan.step).reshape(-1, plan.chunk)


def stitch_windows(blocks: Tensor, plan: StreamPlan) -> Tensor:
    """Reassemble per-window outputs (n_outer, chunk, B, O, H', W', step)
    into the stream's time axis: (B, O, H', W', n_valid)."""
    blocks = blocks.reshape((plan.n_padded,) + tuple(blocks.shape[2:]))
    blocks = torch.movedim(blocks, 0, -2)  # (B, O, H', W', n_padded, step)
    y = blocks.reshape(tuple(blocks.shape[:-2]) + (plan.n_padded * plan.step,))
    return y[..., : plan.n_valid]
