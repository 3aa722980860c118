"""Hopper CUDA kernels of the serving path and their ctypes wrappers.

The sources live in ``csrc/stmul.cu`` (plain C entry points, see the
note at its top for what each kernel replaces, what bounds it on the
card and how its design answers that).  :mod:`repro_torch.kernels._build`
compiles them with ``nvcc`` for ``sm_90a`` on first use and loads them
with ``ctypes``; :func:`build` does it eagerly and reports the compile.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch reported an error,
and adds one to its ``launches`` counter.  The plain torch versions the
wrappers are held against live in :mod:`repro_torch.kernels.stmul.ref`;
the routing between the two (by the tensor's device) is in
:mod:`repro_torch.kernels.stmul.ops`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, I64, VP, CudaLibrary

Tensor = torch.Tensor

TOPK_MAX_K = 32  # per-thread candidate buffer of the readout kernel
MAC_THREADS = 128  # B1's block (two bins a thread)
MAC_REG_ROWS = 9  # B1's grating rows held in registers at C = 1 (the paper's O)
MAC_MAX_BLOCKS = 2**31 - 1  # B1's grid, one dimension
MAC_GROUPED_MAX_ROWS = 256  # B2's batch rows: its offsets travel in a kernel parameter
TOPK_THREADS = 256  # threads per block of the readout's first pass
TOPK_FILL_BLOCKS = 4 * 132  # first-pass blocks that fill an H100: four per SM
TOPK_MIN_PER_THREAD = 16  # scores each first-pass thread reads, at least


def topk_plan(rows: int, L: int) -> tuple[int, int]:
    """B3's split of the score axis: ``(S, n)``, S slices of n scores per
    row (the last one shorter), slice s covering ``[s·n, min((s+1)·n, L))``.

    ``rows · S`` reaches ``TOPK_FILL_BLOCKS`` unless that would give a
    thread fewer than ``TOPK_MIN_PER_THREAD`` scores, in which case the
    slices stay at that minimum length.  n is a multiple of 4, so every
    slice starts on a 16-byte boundary of its row (and of the matrix when
    L % 4 == 0)."""
    rows, L = int(rows), int(L)
    if rows < 1 or L < 1:
        raise ValueError(f"no scores to split: rows={rows}, L={L}")
    want = -(-TOPK_FILL_BLOCKS // rows)
    n = max(-(-L // want), TOPK_THREADS * TOPK_MIN_PER_THREAD)
    n = -(-n // 4) * 4
    return -(-L // n), n


def mac_plan(B: int, O: int, C: int, F: int) -> tuple[int, int, str]:
    """B1's launch plan, as ``stmul_mac`` computes it, for B batch rows
    against O grating rows of C channels over F bins: ``(blocks, rows,
    where)``.  Block ``k`` takes bin tile ``k // B`` (``2·MAC_THREADS``
    bins, two a thread) and batch row ``k % B``, so a tile's B blocks sit
    next to each other in the grid.  A block walks the O axis ``rows``
    grating rows at a time, held ``where``:

    * ``"registers"`` at C = 1: up to ``MAC_REG_ROWS`` rows;
    * ``"global"`` at C > 1: all O rows, x and g read per output row."""
    B, O, C, F = int(B), int(O), int(C), int(F)
    if min(B, O, C, F) < 1:
        raise ValueError(f"no MAC to plan: B={B}, O={O}, C={C}, F={F}")
    blocks = -(-F // (2 * MAC_THREADS)) * B
    if C == 1:
        return blocks, min(O, MAC_REG_ROWS), "registers"
    return blocks, O, "global"


_LIB = CudaLibrary(
    "stmul",
    Path(__file__).resolve().parent / "csrc",
    {
        "stmul_mac": [VP, VP, VP, I32, I32, I32, I64, I32, VP],
        "stmul_mac_grouped": [VP, VP, VP, VP, VP, I32, I32, I64, I32, I32, VP],
        "stmul_topk": [VP, VP, VP, VP, VP, I32, I64, I32, I32, I64, VP],
    },
)
build = _LIB.build


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    _build.reset(spectral_mac_cuda, spectral_mac_grouped_cuda, topk_readout_cuda)


def spectral_mac_cuda(x: Tensor, g: Tensor, version: int = 2) -> Tensor:
    """B1: ``y[b, o, f] = Σ_c x[b, c, f] · g[o, c, f]`` on complex64
    (B, C, F) and (O, C, F); returns complex64 (B, O, F), launched as
    :func:`mac_plan` says."""
    _build.require(x, "x", torch.complex64, 3)
    _build.require(g, "g", torch.complex64, 3)
    B, C, F = x.shape
    O = g.shape[0]
    if g.shape[1:] != (C, F) or g.device != x.device:
        raise ValueError(f"grating {tuple(g.shape)} does not match x {tuple(x.shape)}")
    if version not in (1, 2):
        raise ValueError(f"unknown stmul kernel version {version!r}")
    if min(B, O, C, F) < 1:
        raise ValueError(f"empty MAC: x {tuple(x.shape)}, grating {tuple(g.shape)}")
    if mac_plan(B, O, C, F)[0] > MAC_MAX_BLOCKS:
        raise ValueError(f"x {tuple(x.shape)}, grating {tuple(g.shape)}: B1's grid is too large")
    y = torch.empty((B, O, F), dtype=torch.complex64, device=x.device)
    rc = _LIB.lib().stmul_mac(
        x.data_ptr(), g.data_ptr(), y.data_ptr(), B, O, C, F, int(version), _build.stream(),
    )
    _build.check(rc, "stmul_mac")
    _build.count(spectral_mac_cuda)
    return y


def spectral_mac_grouped_cuda(
    x: Tensor,
    pool_re: Tensor,
    pool_im: Tensor,
    o_start: Sequence[int],
    n_out: int,
) -> Tensor:
    """B2: ``y[b, o, f] = Σ_c x[b, c, f] · g[o_start[b] + o, c, f]`` with
    x complex64 (B, C, F) and split arena planes (ΣO, C, F) float32 or
    bfloat16; ``o_start`` holds B host-side row offsets.  Returns
    complex64 (B, n_out, F)."""
    _build.require(x, "x", torch.complex64, 3)
    if pool_re.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"arena planes must be float32 or bfloat16, got {pool_re.dtype}")
    _build.require(pool_re, "pool_re", pool_re.dtype, 3)
    _build.require(pool_im, "pool_im", pool_re.dtype, 3)
    B, C, F = x.shape
    rows = int(pool_re.shape[0])
    if pool_re.shape[1:] != (C, F) or pool_im.shape != pool_re.shape:
        raise ValueError(
            f"arena planes {tuple(pool_re.shape)} do not match x {tuple(x.shape)}"
        )
    offs = [int(o) for o in o_start]
    if len(offs) != B:
        raise ValueError(f"o_start has {len(offs)} entries for {B} rows")
    n_out = int(n_out)
    if min(offs) < 0 or max(offs) + n_out > rows:
        raise ValueError(
            f"o_start + n_out reads rows up to {max(offs) + n_out} of an "
            f"arena of {rows}"
        )
    if not (0 < B <= MAC_GROUPED_MAX_ROWS and n_out > 0):
        raise ValueError(
            f"B={B}, n_out={n_out}: the kernel takes 1..{MAC_GROUPED_MAX_ROWS} rows"
        )
    # host int32 offsets: the C side copies them into the kernel's
    # parameter block, so no device copy precedes the launch
    off = np.asarray(offs, dtype=np.int32)
    y = torch.empty((B, n_out, F), dtype=torch.complex64, device=x.device)
    rc = _LIB.lib().stmul_mac_grouped(
        x.data_ptr(), pool_re.data_ptr(), pool_im.data_ptr(), off.ctypes.data,
        y.data_ptr(), B, C, F, n_out, int(pool_re.dtype == torch.bfloat16),
        _build.stream(),
    )
    _build.check(rc, "stmul_mac_grouped")
    _build.count(spectral_mac_grouped_cuda)
    return y


def topk_readout_cuda(vals: Tensor, gidx: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """B3: per row of ``vals`` (R, L) float32 the k best (score, index)
    pairs, ``gidx`` (L,) int32 the shared global positions.  Returns
    (R, k) float32 scores and int32 indices, bitwise equal to
    :func:`repro_torch.kernels.stmul.ref.topk_select`.  Two launches
    (per-slice partial top-k over :func:`topk_plan`'s slices, then a
    per-row merge) count as one call."""
    _build.require(vals, "vals", torch.float32, 2)
    _build.require(gidx, "gidx", torch.int32, 1)
    R, L = vals.shape
    k = int(k)
    if gidx.shape[0] != L:
        raise ValueError(f"gidx has {gidx.shape[0]} entries for L={L}")
    if not 1 <= k <= TOPK_MAX_K:
        raise ValueError(f"k={k} outside 1..{TOPK_MAX_K}")
    if L == 0:
        raise ValueError("empty score axis")
    s = torch.empty((R, k), dtype=torch.float32, device=vals.device)
    ix = torch.empty((R, k), dtype=torch.int32, device=vals.device)
    if R == 0:
        return s, ix
    S, n = topk_plan(R, L)
    # pass 1's (R, S, k) pairs and (R, S) NaN flags, read by pass 2
    ws = torch.empty(R * S * (2 * k + 1), dtype=torch.int32, device=vals.device)
    rc = _LIB.lib().stmul_topk(
        vals.data_ptr(), gidx.data_ptr(), s.data_ptr(), ix.data_ptr(), ws.data_ptr(),
        R, L, k, S, n, _build.stream(),
    )
    _build.check(rc, "stmul_topk")
    _build.count(topk_readout_cuda)
    return s, ix


spectral_mac_cuda.launches = 0
spectral_mac_grouped_cuda.launches = 0
topk_readout_cuda.launches = 0
