"""Plain torch versions of the Mamba-2 SSD (state-space dual) operator
(port of ``repro.kernels.ssd.ref``).

The selective state-space recurrence, per head h with state size N and
head dim P:

    a_t = exp(dt_t · A)                        (scalar per head, A < 0)
    S_t = a_t · S_{t−1} + dt_t · x_t ⊗ B_t     (S: P×N)
    y_t = S_t · C_t                            (P,)

:func:`ssd_scan_ref` is the exact sequential recurrence (slow, the
ground truth).  :func:`ssd_chunked_ref` is the chunked SSD algorithm —
the math the CUDA kernel implements (intra-chunk quadratic form +
inter-chunk state carry) — and is the kernel's plain version on the CPU
and on the card.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def ssd_scan_ref(
    x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor
) -> tuple[Tensor, Tensor]:
    """Exact sequential recurrence.

    Args:
      x: (Bb, L, H, P), dt: (Bb, L, H) positive, A: (H,) negative,
      B, C: (Bb, L, G, N) with G | H (grouped state, GQA-style).

    Returns:
      y: (Bb, L, H, P), final_state: (Bb, H, P, N).
    """
    Bb, L, H, P = x.shape
    N = B.shape[3]
    rep = H // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2)  # (Bb, L, H, N)
    Ch = C.repeat_interleave(rep, dim=2)
    S = x.new_zeros((Bb, H, P, N))
    ys = []
    for t in range(L):
        a_t = torch.exp(dt[:, t] * A[None, :])  # (Bb, H)
        S = S * a_t[..., None, None] + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[
            :, t, :, None, :
        ]
        ys.append(torch.einsum("bhpn,bhn->bhp", S, Ch[:, t]))
    return torch.stack(ys, dim=1), S


def ssd_chunked_ref(
    x: Tensor,
    dt: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    chunk: int = 64,
    initial_state: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Chunked SSD: quadratic intra-chunk form + linear inter-chunk carry.

    Same signature/semantics as :func:`ssd_scan_ref` (plus an optional
    initial state for sequence-parallel composition).  L must be a
    multiple of ``chunk``.
    """
    Bb, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    if L % chunk:
        raise ValueError(f"L={L} not a multiple of chunk={chunk}")
    nc = L // chunk

    Bh = B.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2)

    # chunks: (Bb, nc, Q, H, ...)
    xq = x.reshape(Bb, nc, chunk, H, P)
    dtq = dt.reshape(Bb, nc, chunk, H)
    bq = Bh.reshape(Bb, nc, chunk, H, N)
    cq = Ch.reshape(Bb, nc, chunk, H, N)

    a_log = dtq * A[None, None, None, :]  # (Bb, nc, Q, H) ≤ 0
    seg = torch.cumsum(a_log, dim=2)  # within-chunk cumulative log-decay
    total = seg[:, :, -1:, :]  # (Bb, nc, 1, H)

    # ---- intra-chunk (quadratic, causal-masked) ----
    # decay(i←j) = exp(seg_i − seg_j) for i ≥ j.  For i < j the difference
    # is positive and exp may overflow to inf, and inf·0 would be NaN: the
    # mask goes in before the exp, so masked entries are exp(−inf) = 0.
    d = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (Bb,nc,Q,Q,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(d.masked_fill(~mask[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bkihn,bkjhn->bkijh", cq, bq) * decay
    xdt = xq * dtq[..., None]
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", scores, xdt)

    # ---- inter-chunk state recurrence ----
    # chunk-local state contribution: Σ_j exp(total − seg_j)·dt_j·x_j⊗B_j
    carry_w = torch.exp(total - seg)  # (Bb, nc, Q, H)
    S_loc = torch.einsum("bkjh,bkjhp,bkjhn->bkhpn", carry_w, xdt, bq)
    chunk_decay = torch.exp(total[:, :, 0, :])  # (Bb, nc, H)

    S = initial_state if initial_state is not None else x.new_zeros((Bb, H, P, N))
    S_ins = []  # state entering each chunk
    for k in range(nc):
        S_ins.append(S)
        S = S * chunk_decay[:, k, :, None, None] + S_loc[:, k]
    S_in = torch.stack(S_ins, dim=1)  # (Bb, nc, H, P, N)

    # inter-chunk output: y_i += C_i · exp(seg_i) · S_in
    y_inter = torch.einsum("bkihn,bkih,bkhpn->bkihp", cq, torch.exp(seg), S_in)

    y = (y_intra + y_inter).reshape(Bb, L, H, P)
    return y, S


# ---- the CUDA kernel's three passes, step by step (used by the tests) -------


def ssd_chunk_states_ref(
    x: Tensor, dt: Tensor, A: Tensor, B: Tensor, chunk: int
) -> tuple[Tensor, Tensor]:
    """Pass 1: per (b, h, chunk) the sequential float32 cumsum ``seg`` of
    the rounded dt·A (Bb, H, nc, Q) and the chunk's local state
    ΔS = (x·dt·e^{total − seg})ᵀ·B (Bb, H, nc, P, N)."""
    Bb, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = L // chunk
    dtq = dt.reshape(Bb, nc, chunk, H).permute(0, 3, 1, 2)  # (Bb, H, nc, Q)
    seg = torch.cumsum(dtq * A[None, :, None, None], dim=-1)
    w = torch.exp(seg[..., -1:] - seg)
    xq = x.reshape(Bb, nc, chunk, H, P).permute(0, 3, 1, 2, 4)  # (Bb, H, nc, Q, P)
    xw = xq * dtq[..., None] * w[..., None]
    bq = B.repeat_interleave(H // G, dim=2).reshape(Bb, nc, chunk, H, N).permute(0, 3, 1, 2, 4)
    return seg, xw.transpose(-1, -2) @ bq


def ssd_state_passing_ref(dS: Tensor, seg: Tensor) -> tuple[Tensor, Tensor]:
    """Pass 2: the state entering each chunk, S_in(c + 1) = e^{total_c} ·
    S_in(c) + ΔS_c from S_in(0) = 0 (Bb, H, nc, P, N), and the final
    state (Bb, H, P, N)."""
    S = torch.zeros_like(dS[:, :, 0])
    S_in = []
    for c in range(dS.shape[2]):
        S_in.append(S)
        S = torch.exp(seg[:, :, c, -1])[..., None, None] * S + dS[:, :, c]
    return torch.stack(S_in, dim=2), S


def ssd_chunk_scan_ref(
    x: Tensor, dt: Tensor, B: Tensor, C: Tensor, seg: Tensor, S_in: Tensor, chunk: int
) -> Tensor:
    """Pass 3: per (b, h, chunk) y = e^{seg_i}·(C·S_inᵀ) + (scores ⊙
    decay)·(dt·x), the causal mask applied before the exponential."""
    Bb, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = L // chunk

    def by_chunk(t, width):  # (Bb, L, H', width) -> (Bb, H, nc, Q, width)
        t = t.repeat_interleave(H // t.shape[2], dim=2)
        return t.reshape(Bb, nc, chunk, H, width).permute(0, 3, 1, 2, 4)

    xq, bq, cq = by_chunk(x, P), by_chunk(B, N), by_chunk(C, N)
    dtq = dt.reshape(Bb, nc, chunk, H).permute(0, 3, 1, 2)
    y_inter = torch.exp(seg)[..., None] * (cq @ S_in.transpose(-1, -2))
    d = seg[..., :, None] - seg[..., None, :]
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    scores = (cq @ bq.transpose(-1, -2)) * torch.exp(d.masked_fill(~mask, float("-inf")))
    y = y_inter + scores @ (xq * dtq[..., None])
    return y.permute(0, 2, 3, 1, 4).reshape(Bb, L, H, P)


def ssd_three_pass_ref(
    x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, chunk: int
) -> tuple[Tensor, Tensor]:
    """The CUDA kernel's decomposition of :func:`ssd_chunked_ref` (from a
    zero state): chunk states, state passing, chunk scan.  L must be a
    multiple of ``chunk``."""
    if x.shape[1] % chunk:
        raise ValueError(f"L={x.shape[1]} not a multiple of chunk={chunk}")
    seg, dS = ssd_chunk_states_ref(x, dt, A, B, chunk)
    S_in, S = ssd_state_passing_ref(dS, seg)
    return ssd_chunk_scan_ref(x, dt, B, C, seg, S_in, chunk), S
