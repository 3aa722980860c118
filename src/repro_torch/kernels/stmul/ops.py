"""Public wrappers of the stmul kernels (port of ``repro.kernels.stmul.ops``).

Each function keeps the reference's signature on complex tensors with
arbitrary trailing frequency axes, flattens them, and routes by the
tensor's device: a CUDA tensor launches the hand-written kernel of
``kernel.py`` (or raises), a CPU tensor runs its plain version from
``ref.py``, and a ``meta`` tensor gets outputs of the right shapes and
dtypes on ``meta`` and no arithmetic (the dry run's route).  There is
no fallback from one to the other.  The kernels have no backward: on
the card and on ``meta``, a call in grad mode whose inputs require a
gradient raises (a CPU call's plain version is differentiable).  Under
``launch.op_analysis.OpCounter`` each kernel call counts as one op by
its own formula on every route.

The TPU kernels needed a real/imag plane split and a ``yr + 1j*yi``
recombination around every launch; the CUDA kernels read and write
interleaved complex64 — the layout ``torch.fft.rfftn`` produces — so
that traffic is gone.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import tracing
from repro_torch.kernels.stmul import kernel as _kernel
from repro_torch.kernels.stmul import ref as _ref
from repro_torch.launch import op_analysis

Tensor = torch.Tensor

_FFT_AXES = (-3, -2, -1)


def _on_cuda(*inputs: Tensor) -> bool:
    """Whether the call launches its kernel: True when the first input is
    a CUDA tensor, False for a CPU or ``meta`` one.  The kernels have no
    backward (nor have the reference's), so a CUDA or ``meta`` call in
    grad mode on inputs that require a gradient raises instead of
    returning a result cut from the graph."""
    t = inputs[0]
    if t.device.type in ("cuda", "meta"):
        if torch.is_grad_enabled() and any(i.requires_grad for i in inputs):
            raise ValueError(
                "the stmul kernels have no backward: an input requires a gradient; "
                "call them under torch.no_grad() (the STHC routes are inference-only "
                "on the card)"
            )
        return t.device.type == "cuda"
    if t.device.type == "cpu":
        return False
    raise ValueError(f"stmul has no kernel for device {t.device}")


@op_analysis.counted_kernel(
    "spectral_mac", lambda xf, gf, version: dict(B=xf.shape[0], O=gf.shape[0], C=xf.shape[1], F=xf.shape[2])
)
def _mac(xf: Tensor, gf: Tensor, version: int) -> Tensor:
    if _on_cuda(xf, gf):
        return _kernel.spectral_mac_cuda(xf.contiguous(), gf.contiguous(), version)
    if xf.device.type == "meta":
        return xf.new_empty((xf.shape[0], gf.shape[0], xf.shape[2]))
    return _ref.spectral_mac_ref(xf, gf, version)


def _grouped_shape(xf, pr, pi, o_start, n_out) -> dict:
    B, C, F = xf.shape
    return dict(B=B, C=C, F=F, o_start=tuple(o_start), n_out=int(n_out), itemsize=pr.element_size())


@op_analysis.counted_kernel("spectral_mac_grouped", _grouped_shape)
def _mac_grouped(xf: Tensor, pr: Tensor, pi: Tensor, o_start: Sequence[int], n_out: int) -> Tensor:
    if _on_cuda(xf, pr, pi):
        return _kernel.spectral_mac_grouped_cuda(
            xf.contiguous(), pr.contiguous(), pi.contiguous(), o_start, n_out
        )
    if xf.device.type == "meta":
        return xf.new_empty((xf.shape[0], int(n_out), xf.shape[2]))
    return _ref.spectral_mac_grouped_ref(xf, pr, pi, o_start, n_out)


@op_analysis.counted_kernel("topk_readout", lambda flat, gidx, k: dict(R=flat.shape[0], L=flat.shape[1], k=k))
def _topk(flat: Tensor, gidx: Tensor, k: int) -> tuple[Tensor, Tensor]:
    if _on_cuda(flat):
        return _kernel.topk_readout_cuda(
            flat.to(torch.float32).contiguous(), gidx.to(torch.int32).contiguous(), k
        )
    if flat.device.type == "meta":
        R = flat.shape[0]
        return (torch.empty((R, k), dtype=torch.float32, device="meta"),
                torch.empty((R, k), dtype=torch.int32, device="meta"))
    return _ref.topk_readout_ref(flat, gidx, k)


def spectral_mac(xhat: Tensor, grating: Tensor, *, version: int = 2) -> Tensor:
    """Complex channel-contracted spectral product (kernel B1).

    Args:
      xhat: (B, C, *F) complex64; grating: (O, C, *F) complex64.
      version: 2 = Karatsuba 3-multiply (default), 1 = direct 4-multiply.

    Returns (B, O, *F) complex64.
    """
    fshape = tuple(xhat.shape[2:])
    B, C = xhat.shape[:2]
    O = grating.shape[0]
    xf = xhat.reshape(B, C, -1)
    gf = grating.reshape(O, C, -1)
    return _mac(xf, gf, version).reshape((B, O) + fshape)


def spectral_mac_grouped(
    xhat: Tensor,
    pool_re: Tensor,
    pool_im: Tensor,
    o_start: Sequence[int],
    n_out: int,
) -> Tensor:
    """Pooled cross-tenant spectral MAC (kernel B2).

        Ŷ[b, o, f] = Σ_c  X̂[b, c, f] · Gpool[o_start[b] + o, c, f]

    Args:
      xhat: (B, C, *F) complex64 query spectra (the mixed-tenant batch).
      pool_re / pool_im: (ΣO, C, *F) float32 or bfloat16 arena planes.
      o_start: B per-row first-row offsets into the arena (host ints).
      n_out: O rows produced per query row.

    Returns (B, n_out, *F) complex64.
    """
    fshape = tuple(xhat.shape[2:])
    B, C = xhat.shape[:2]
    so = pool_re.shape[0]
    xf = xhat.reshape(B, C, -1)
    pr = pool_re.reshape(so, C, -1)
    pi = pool_im.reshape(so, C, -1)
    return _mac_grouped(xf, pr, pi, o_start, n_out).reshape((B, int(n_out)) + fshape)


def query_grating_pooled(
    x: Tensor,
    pool_re: Tensor,
    pool_im: Tensor,
    o_start: Sequence[int],
    n_out: int,
    fft_shape: tuple[int, int, int],
    out_shape: tuple[int, int, int],
) -> Tensor:
    """One forward FFT over the stacked mixed-tenant batch, one grouped
    MAC against the pooled arena, one inverse FFT, crop."""
    with tracing.span("stmul.rfftn"):
        xhat = torch.fft.rfftn(x, s=fft_shape, dim=_FFT_AXES)
    with tracing.span("stmul.mac"):
        yhat = spectral_mac_grouped(xhat, pool_re, pool_im, o_start, n_out)
    with tracing.span("stmul.irfftn"):
        y = torch.fft.irfftn(yhat, s=fft_shape, dim=_FFT_AXES)
    return y[..., : out_shape[0], : out_shape[1], : out_shape[2]]


def pooled_query_shard(
    x: Tensor,
    pool_re: Tensor,
    pool_im: Tensor,
    fft_shape: tuple[int, int, int],
    out_shape: tuple[int, int, int],
) -> Tensor:
    """Shard-local full-arena fan-out: :func:`query_grating_pooled` with
    every clip row reading the local arena tile whole (zero offsets,
    ``n_out`` = the tile's rows) — the grouped-MAC body of the engine's
    mesh executor, where each model shard holds one tile and no offset
    crosses a shard."""
    rows = [0] * int(x.shape[0])
    return query_grating_pooled(
        x, pool_re, pool_im, rows, int(pool_re.shape[0]), fft_shape, out_shape
    )


def query_grating_pallas(
    x: Tensor,
    grating: Tensor,
    fft_shape: tuple[int, int, int],
    out_shape: tuple[int, int, int],
    *,
    version: int = 2,
) -> Tensor:
    """Kernel counterpart of ``spectral_conv.query_grating``: rfftn, the
    B1 MAC, irfftn, crop.  (The name is the reference's.)"""
    with tracing.span("stmul.rfftn"):
        xhat = torch.fft.rfftn(x, s=fft_shape, dim=_FFT_AXES)
    with tracing.span("stmul.mac"):
        yhat = spectral_mac(xhat, grating, version=version)
    with tracing.span("stmul.irfftn"):
        y = torch.fft.irfftn(yhat, s=fft_shape, dim=_FFT_AXES)
    return y[..., : out_shape[0], : out_shape[1], : out_shape[2]]


def topk_readout(
    vals: Tensor, gidx: Tensor, k: int, *, use_pallas: bool = True
) -> tuple[Tensor, Tensor]:
    """Fused detection readout (kernel B3): reduce a flattened score axis
    to the K best (score, global position) pairs per (row, kernel).

    Args:
      vals: (B, O, L) float32 scores (padding carries −inf).
      gidx: (L,) int32 global flat positions (``TOPK_EMPTY_IDX`` pads).
      k: state width.
      use_pallas: route through the readout kernel (its plain version on
        CPU tensors); False runs the same selection as one dense
        :func:`ref.topk_select` — both are bitwise equal.

    Returns (scores, index): (B, O, k) float32 / int32.
    """
    k = int(k)
    if not use_pallas:
        return _ref.topk_select(vals, gidx.expand(vals.shape), k)
    lead = tuple(vals.shape[:-1])
    flat = vals.reshape(-1, vals.shape[-1])
    s, ix = _topk(flat, gidx, k)
    return s.reshape(lead + (k,)), ix.reshape(lead + (k,))


def merge_topk(states: "list[tuple[Tensor, Tensor]]", k: int) -> tuple[Tensor, Tensor]:
    """Associative merge of top-K running states: the exact top-k of the
    union of (scores, index) pairs, each (..., K_i) — any re-chunking or
    permutation of the states gives a bitwise-identical result."""
    s = torch.cat([st[0] for st in states], dim=-1)
    i = torch.cat([st[1] for st in states], dim=-1)
    return _ref.topk_select(s, i, int(k))
