"""Plain torch versions of the stmul kernels (the port's oracles).

Each function computes what its CUDA kernel in ``kernel.py`` computes,
in the same order of rounded operations, so on the same inputs the two
agree bit for bit:

* :func:`spectral_mac_ref` — B1, the complex channel-contracted MAC
  ``Ŷ[b, o, f] = Σ_c X̂[b, c, f] · G[o, c, f]`` (v2 Karatsuba or v1
  direct);
* :func:`spectral_mac_grouped_ref` — B2, the same against each row's
  own O-slice of a pooled split-plane arena (f32 or bf16 planes,
  f32 accumulation);
* :func:`topk_select` / :func:`topk_readout_ref` — B3, the fused
  detection readout: top-k under the total order score descending,
  index ascending.  It copies the reference's iterative max /
  min-index algorithm (``repro/kernels/stmul/kernel.py:351``) step for
  step; ``torch.topk`` is no twin (it ranks NaN first and leaves tie
  order unspecified).

The wrappers in ``ops.py`` run these on CPU tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch

Tensor = torch.Tensor

TOPK_EMPTY_IDX = 2**31 - 1


def _mac_planes(
    xr: Tensor, xi: Tensor, gr: Tensor, gi: Tensor, version: int
) -> Tensor:
    """Σ_c over planes x (B, 1, C, F) and g (B or 1, O, C, F), one
    channel at a time in the kernel's op order; returns complex64
    (B, O, F)."""
    C = xr.shape[2]
    s0 = s1 = s2 = None
    for c in range(C):
        a, b = xr[:, :, c], xi[:, :, c]
        p, q = gr[:, :, c], gi[:, :, c]
        if version == 2:
            t = (a * p, b * q, (a + b) * (p + q))
        elif version == 1:
            t = (a * p - b * q, a * q + b * p, None)
        else:
            raise ValueError(f"unknown stmul kernel version {version!r}")
        if c == 0:
            s0, s1, s2 = t
        else:
            s0, s1 = s0 + t[0], s1 + t[1]
            s2 = None if t[2] is None else s2 + t[2]
    if version == 2:
        return torch.complex(s0 - s1, s2 - s0 - s1)
    return torch.complex(s0, s1)


def spectral_mac_ref(xhat: Tensor, grating: Tensor, version: int = 2) -> Tensor:
    """B1's plain version: xhat (B, C, F), grating (O, C, F) complex64 →
    (B, O, F) complex64."""
    return _mac_planes(
        xhat.real[:, None], xhat.imag[:, None],
        grating.real[None], grating.imag[None], version,
    )


def spectral_mac_grouped_ref(
    xhat: Tensor,
    pool_re: Tensor,
    pool_im: Tensor,
    o_start: Sequence[int],
    n_out: int,
) -> Tensor:
    """B2's plain version: xhat (B, C, F) complex64, arena planes
    (ΣO, C, F) f32 or bf16, per-row first-row offsets ``o_start`` →
    (B, n_out, F) complex64 (Karatsuba, f32 accumulation)."""
    rows = torch.as_tensor(list(o_start), dtype=torch.long, device=xhat.device)
    idx = rows[:, None] + torch.arange(int(n_out), device=xhat.device)[None, :]
    gr = pool_re[idx].to(torch.float32)  # (B, n_out, C, F)
    gi = pool_im[idx].to(torch.float32)
    return _mac_planes(xhat.real[:, None], xhat.imag[:, None], gr, gi, 2)


def topk_select(vals: Tensor, gidx: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Top-k along the last axis under a *total* order: score
    descending, then global index ascending (k = 1 is ``argmax``'s
    first-occurrence rule).

    NaN poisons: the max is NaN, the equality mask matches nothing, and
    every slot reports (NaN, ``TOPK_EMPTY_IDX``); a slot whose max is
    −inf (candidates exhausted) reports ``TOPK_EMPTY_IDX``.  A slot's
    score is the value stored at the selected position (so among
    value-equal ±0 the reported sign is that of the winning element, a
    choice the CUDA kernel makes identically).

    Args:
      vals: (..., L) float32 scores.
      gidx: (..., L) int32 global positions, unique along the axis.
      k: number of survivors.

    Returns (scores, index): (..., k) each, sorted by the total order.
    """
    out_s, out_i = [], []
    L = vals.shape[-1]
    big = torch.full((), TOPK_EMPTY_IDX, dtype=gidx.dtype, device=gidx.device)
    neg = torch.full((), float("-inf"), dtype=vals.dtype, device=vals.device)
    nan = torch.full((), float("nan"), dtype=vals.dtype, device=vals.device)
    pos = torch.arange(L, device=vals.device).expand(vals.shape)
    for _ in range(int(k)):
        m = torch.amax(vals, dim=-1, keepdim=True)
        hit = vals == m
        sel = torch.amin(torch.where(hit, gidx, big), dim=-1, keepdim=True)
        sel = torch.where(m == neg, big, sel)
        p = torch.amin(
            torch.where(hit & (gidx == sel), pos, L), dim=-1, keepdim=True
        )
        found = p < L
        picked = torch.gather(vals, -1, torch.clamp(p, max=L - 1))
        # canonical quiet NaN for poisoned rows, as the kernel writes
        out_s.append(torch.where(found, picked, torch.where(m != m, nan, m)))
        out_i.append(sel)
        vals = torch.where(pos == p, neg, vals)
    return torch.cat(out_s, -1), torch.cat(out_i, -1)


def topk_readout_ref(vals: Tensor, gidx: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """B3's plain version: ``vals`` (..., L) float32, ``gidx`` (L,) int32
    shared by every row → (..., k) float32 scores, int32 indices."""
    return topk_select(vals, gidx.expand(vals.shape), k)
