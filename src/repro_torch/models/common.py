"""Shared building blocks of the port's models (the part of
``repro.models.common`` that the ported families use): init, RMSNorm,
LayerNorm, RoPE, sinusoidal positions, blockwise and decode attention,
activations, the cross-entropy loss and rematerialisation.

Parameters are initialised with an explicit ``torch.Generator``; the
numbers differ from ``jax.random``'s for the same seed, so parity tests
carry the reference's weights across (``repro_torch.interop``) rather
than re-seeding.  Norm statistics stay float32 and cast back to the
input's dtype, as in the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch
from torch.utils import checkpoint as _ckpt

Tensor = torch.Tensor


def dense_init(
    generator: torch.Generator,
    shape: tuple[int, ...],
    dtype: torch.dtype,
    scale: float | None = None,
) -> Tensor:
    """Truncated-normal init on [−2, 2] (std = 1/sqrt(fan_in) unless
    given), drawn in float32 on the generator's device, cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    # inverse-CDF sampling of the standard normal restricted to [−2, 2]
    lo, hi = (1.0 + math.erf(-math.sqrt(2.0))) / 2, (1.0 + math.erf(math.sqrt(2.0))) / 2
    u = torch.rand(shape, generator=generator, device=generator.device)
    w = torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0) * math.sqrt(2.0)
    return (w.clamp(-2.0, 2.0) * std).to(dtype)


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """The reference's LayerNorm arithmetic (not ``F.layer_norm``): the
    mean and the population variance in float32, ``(x − μ)·rsqrt(var +
    eps)·w + b`` in float32, cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def zeros_init(shape: tuple[int, ...], dtype: torch.dtype, device=None) -> Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape: tuple[int, ...], dtype: torch.dtype, device=None) -> Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def stacked_axes(axes: dict, lead: tuple[str, ...] = ("layers",)) -> dict:
    """A logical-axes tree (nested dicts of tuples) with ``lead`` put in
    front of every leaf: the axes the reference gives a layer tree it
    stacks for ``lax.scan``."""
    return {k: stacked_axes(v, lead) if isinstance(v, dict) else lead + v for k, v in axes.items()}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> Tensor:
    """Inverse frequencies (head_dim/2,), float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Rotary embedding, half-split (not interleaved).  x: (B, S, H, D);
    positions: (B, S) integer.  Angles and the rotation in float32, the
    result cast back to x's dtype."""
    inv = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    ang = positions[..., None].float() * inv[None, None, :]  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, D/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> Tensor:
    """The classic sinusoidal table (n, d), float32, interleaved as the
    reference's (Whisper's encoder): sin in the even columns, cos in the
    odd ones."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(
        torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d)
    )
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div[None, :])
    pe[:, 1::2] = torch.cos(pos * div[None, :])
    return pe


# ---------------------------------------------------------------------------
# Attention (plain torch; the flash kernel's plain version is
# blockwise_attention)
# ---------------------------------------------------------------------------

NEG = -1e30  # the mask value of masked scores


def _dot_f32(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """einsum with float32 accumulation over inputs of any float dtype
    (the reference's ``preferred_element_type=float32``): bf16 products
    are exact in float32, so widening first changes nothing but the
    accumulator."""
    return torch.einsum(eq, a.float(), b.float())


def blockwise_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_len: Tensor | None = None,
    block_k: int = 512,
    softmax_scale: float | None = None,
) -> Tensor:
    """Online-softmax attention with native GQA, O(Sq·block_k) memory.

    q: (B, Sq, H, Dq); k: (B, Sk, G, Dq); v: (B, Sk, G, Dv), G | H (query
    head h reads kv head h // (H/G)).  ``q_offset`` is the absolute
    position of q[0]; ``kv_len`` optional (B,) valid kv lengths.  As the
    reference: q is scaled in q's dtype before the dot, scores are
    float32, masked scores are −1e30, the running max starts at −inf, p
    is cast to v's dtype before the p·v dot.  Returns (B, Sq, H, Dv) in
    q's dtype.
    """
    B, Sq, H, Dq = q.shape
    Sk, G = k.shape[1], k.shape[2]
    R = H // G
    Dv = v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(Dq)

    qf = (q * scale).reshape(B, Sq, G, R, Dq)  # stays in q's dtype
    block_k = min(block_k, Sk)
    pad_k = (-Sk) % block_k
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    n_blocks = (Sk + pad_k) // block_k
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)  # (Sq,) absolute
    limit = kv_len[:, None] if kv_len is not None else torch.tensor(Sk, device=dev)

    m = torch.full((B, G, R, Sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, G, R, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, G, R, Sq, Dv), dtype=torch.float32, device=dev)
    for i in range(n_blocks):
        kblk = k[:, i * block_k : (i + 1) * block_k]
        vblk = v[:, i * block_k : (i + 1) * block_k]
        s = _dot_f32("bqgrd,bkgd->bgrqk", qf, kblk)  # (B, G, R, Sq, bk)
        k_pos = i * block_k + torch.arange(block_k, device=dev)
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]  # (Sq, bk)
            s = torch.where(mask, s, NEG)
        valid = k_pos[None, :] < limit  # (B, bk) or (1, bk)
        s = torch.where(valid[:, None, None, None, :], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = _dot_f32("bgrqk,bkgd->bgrqd", p.to(vblk.dtype), vblk)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4)  # (B, Sq, G, R, Dv)
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def _cache_dot(a: Tensor, cache: Tensor, transpose: bool) -> Tensor:
    """Per kv head g, ``a[:, g] @ cache[:, :, g]ᵀ`` (``transpose``) or
    ``a[:, g] @ cache[:, :, g]``: a (B, G, n, ·) bf16, cache (B, M, G, D)
    bf16 → (B, G, n, M or D) float32.  One bf16 GEMM with a float32
    output per head (``bmm``'s ``out_dtype``), on a strided view of the
    cache (row stride G·D, unit column stride) that cuBLAS takes as it
    is: the cache is never copied or widened."""
    outs = []
    for g in range(cache.shape[2]):
        c = cache[:, :, g]
        b = c.transpose(1, 2) if transpose else c
        outs.append(torch.bmm(a[:, g], b, out_dtype=torch.float32))
    return torch.stack(outs, dim=1)


def _bf16_gemm_route(q: Tensor, k: Tensor, v: Tensor) -> bool:
    """Decode attention's products run as bf16 GEMMs: a bf16 cache on
    the card, or on ``meta``, so that a dry run counts what the card runs
    (the CPU has no ``bmm`` with ``out_dtype``)."""
    return k.device.type in ("cuda", "meta") and q.dtype == k.dtype == v.dtype == torch.bfloat16


def decode_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    kv_len: Tensor,
    softmax_scale: float | None = None,
) -> Tensor:
    """Single-query attention over a KV cache, in one block (the
    reference leaves it to XLA; here it is plain torch on both devices).

    A bf16 cache on the card goes through bf16 GEMMs with float32
    outputs (:func:`_cache_dot`), as the reference keeps its dot inputs
    in the cache dtype; elsewhere both products run through
    :func:`_dot_f32`.  bf16 products are exact in float32, so the two
    routes differ only in the order of the float32 sums.

    q: (B, 1, H, Dq); k: (B, M, G, Dq); v: (B, M, G, Dv); kv_len: (B,)
    valid lengths.  Returns (B, 1, H, Dv) in q's dtype."""
    B, Sq, H, Dq = q.shape
    M, G = k.shape[1], k.shape[2]
    R = H // G
    Dv = v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(Dq)
    qf = (q * scale).reshape(B, Sq, G, R, Dq)
    gemm = _bf16_gemm_route(q, k, v)
    if gemm:
        qg = qf.permute(0, 2, 3, 1, 4).reshape(B, G, R * Sq, Dq)
        s = _cache_dot(qg, k, transpose=True).reshape(B, G, R, Sq, M)
    else:
        s = _dot_f32("bqgrd,bkgd->bgrqk", qf, k)
    valid = torch.arange(M, device=q.device)[None, :] < kv_len[:, None]  # (B, M)
    s = torch.where(valid[:, None, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if gemm:
        pg = p.to(v.dtype).reshape(B, G, R * Sq, M)
        out = _cache_dot(pg, v, transpose=False).reshape(B, G, R, Sq, Dv)
    else:
        out = _dot_f32("bgrqk,bkgd->bgrqd", p.to(v.dtype), v)
    out = out / torch.clamp(l, min=1e-30)
    out = out.permute(0, 3, 1, 2, 4)  # (B, Sq, G, R, Dv)
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def swiglu(gate: Tensor, up: Tensor) -> Tensor:
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up


def squared_relu(x: Tensor) -> Tensor:
    r = torch.relu(x)
    return r * r


def _gelu(x: Tensor) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable[[Tensor], Tensor]] = {
    "gelu": _gelu,
    "relu": torch.relu,
    "squared_relu": squared_relu,
    "silu": torch.nn.functional.silu,
}


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: Tensor, labels: Tensor, mask: Tensor | None = None) -> Tensor:
    """Mean next-token CE; logits (B, S, V) of any float dtype, labels
    (B, S) integer.  The reference's arithmetic: ``log_softmax`` of the
    logits in float32, the labels' entries gathered, their mean.

    ``mask`` (B, S) excludes positions (padding, an image prefix) from
    both the numerator and the denominator."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -torch.mean(ll)
    mask = mask.float()
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("full", "dots", "none")
# the matrix products whose outputs the 'dots' policy keeps
_DOT_OPS = frozenset(
    getattr(torch.ops.aten, name).default for name in ("mm", "bmm", "addmm", "baddbmm")
)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _records(args) -> bool:
    """Will autograd record a call on ``args``: grad mode on and a tensor,
    or a module's parameter, among them that requires grad?"""
    if not torch.is_grad_enabled():
        return False
    return any(
        (isinstance(a, Tensor) and a.requires_grad)
        or (isinstance(a, torch.nn.Module) and any(p.requires_grad for p in a.parameters()))
        for a in args
    )


def remat(cfg, fn: Callable) -> Callable:
    """``fn`` under activation checkpointing by ``cfg.remat`` and
    ``cfg.remat_policy`` (the reference's ``transformer._remat``): while
    autograd records, ``'full'`` keeps only ``fn``'s inputs and recomputes
    the rest in the backward, ``'dots'`` keeps the outputs of its matrix
    products too, ``'none'`` (or ``remat=False``) checkpoints nothing.
    Where autograd does not record (prefill, decode, ``no_grad``, frozen
    parameters) ``fn`` runs as it is."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; expected one of {REMAT_POLICIES}")
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(_ckpt.create_selective_checkpoint_contexts, _save_dots)

    @functools.wraps(fn)
    def wrapped(*args):
        if not _records(args):
            return fn(*args)
        # the blocks draw no random numbers: no RNG state to replay
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return wrapped
