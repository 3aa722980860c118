"""Zamba-2 hybrid LM: a Mamba-2 backbone and one *shared* attention block
(port of ``repro.models.zamba``).

The shared block is one full-attention transformer block whose weights
are reused at every application site, before each group of
``shared_every`` Mamba layers.  It reads concat(x, x0), the current
hidden state beside the original embedding, and its output is projected
back into the residual stream.  As in the reference, the released
checkpoints' per-site LoRA deltas are left out and RoPE runs inside the
shared block at its full head dim (2·d_model / attn_heads: 160 at
zamba2-2.7b).

:class:`Zamba` is the port's :class:`~repro_torch.models.mamba2.Mamba2`
(config, embedding, final norm, head, an ``nn.ModuleList`` of
``n_layers`` ``Mamba2Block``; the reference stacks them as (n_segments,
shared_every, …) and scans) with one :class:`SharedAttentionBlock`
beside them.  Segment s is the shared block, then layers [s·E,
(s+1)·E).  Parameters are made without ``requires_grad`` (a trainer
turns it on); :func:`loss_fn` is the cross-entropy of ``forward``'s
logits, each Mamba layer rematerialised by ``cfg.remat_policy`` as the
reference's are.

The cache keeps the reference's keys and shapes: a K/V cache per
shared-block site (``attn_k``, ``attn_v`` (n_segments, B, max_len, G,
hd); the sites attend independently), each Mamba layer's states
(``conv`` (n_segments, E, B, d_conv−1, conv_dim), ``ssm`` (n_segments,
E, B, H, P, N) float32), ``x0`` (the prompt's last embedding, which
nothing reads) and the filled ``length``.  Decode writes the new K/V and
every layer's new states into the cache's tensors in place and raises a
``ValueError`` at position ``max_len`` (the reference clamps the write
onto the last slot); ``prefill`` raises when ``max_len`` is shorter than
the prompt.

``attn_impl`` picks the shared block's prefill attention: ``'kernel'``
(the default) goes through
:func:`repro_torch.kernels.flash.ops.flash_attention` (kernel B6 for
CUDA tensors, its plain version for CPU tensors); ``'blockwise'`` runs
the plain :func:`common.blockwise_attention`, the reference's own
computation.  ``ssd_impl`` picks the Mamba layers' SSD route as in
:mod:`repro_torch.models.mamba2`.  Decode attention is plain torch on
both.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import common, mamba2, transformer

Tensor = torch.Tensor

# the shared block's parameters, in the reference's names
SHARED_FIELDS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_up", "w_down", "proj_out")


@dataclasses.dataclass(frozen=True)
class ZambaConfig(mamba2.Mamba2Config):
    family: str = "hybrid"
    shared_every: int = 6  # one shared-attention site per this many mamba layers
    attn_heads: int = 32
    attn_kv_heads: int = 32
    attn_d_ff: int = 10240

    @property
    def n_segments(self) -> int:
        return self.n_layers // self.shared_every

    @property
    def attn_width(self) -> int:
        return 2 * self.d_model  # concat(x, x0)

    @property
    def attn_head_dim(self) -> int:
        return self.attn_width // self.attn_heads

    def num_params(self) -> int:
        base = super().num_params()
        W, F = self.attn_width, self.attn_d_ff
        H, G, hd = self.attn_heads, self.attn_kv_heads, self.attn_head_dim
        shared = (
            W * H * hd + 2 * W * G * hd + H * hd * W  # attn
            + 2 * W * F  # mlp (gelu)
            + W * self.d_model  # down-proj to residual
            + 3 * W  # norms
        )
        return base + shared


def shared_shapes(cfg: ZambaConfig) -> dict[str, tuple[int, ...]]:
    """The shape of each shared-block parameter."""
    W, F = cfg.attn_width, cfg.attn_d_ff
    H, G, hd = cfg.attn_heads, cfg.attn_kv_heads, cfg.attn_head_dim
    return {
        "ln1": (W,), "wq": (W, H * hd), "wk": (W, G * hd), "wv": (W, G * hd),
        "wo": (H * hd, W), "ln2": (W,), "w_up": (W, F), "w_down": (F, W),
        "proj_out": (W, cfg.d_model),
    }


class SharedAttentionBlock(nn.Module):
    """The shared block (the reference's ``_shared_qkv`` and
    ``_shared_block``): attention and a GELU MLP on concat(x, x0), each
    with its residual at that width, then ``proj_out`` added to x."""

    def __init__(self, cfg: ZambaConfig, device):
        super().__init__()
        self.cfg = cfg
        for name, shape in shared_shapes(cfg).items():
            setattr(self, name, mamba2._param(shape, cfg.param_dtype, device))

    def qkv(self, xc: Tensor, positions: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """xc (B, S, 2D) → q (B, S, H, hd), k and v (B, S, G, hd), RoPE on q, k."""
        cfg = self.cfg
        B, S, _ = xc.shape
        H, G, hd = cfg.attn_heads, cfg.attn_kv_heads, cfg.attn_head_dim
        cd = cfg.compute_dtype
        h = common.rms_norm(xc, self.ln1, cfg.norm_eps)
        q = (h @ self.wq.to(cd)).reshape(B, S, H, hd)
        k = (h @ self.wk.to(cd)).reshape(B, S, G, hd)
        v = (h @ self.wv.to(cd)).reshape(B, S, G, hd)
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def finish(self, x: Tensor, xc: Tensor, attn: Tensor) -> Tensor:
        """``wo`` and its residual on xc, the MLP and its residual, then
        x + ``proj_out`` of the result."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        B, S = x.shape[:2]
        xc = xc + attn.reshape(B, S, -1) @ self.wo.to(cd)
        h = common.rms_norm(xc, self.ln2, cfg.norm_eps)
        xc = xc + common.ACTIVATIONS["gelu"](h @ self.w_up.to(cd)) @ self.w_down.to(cd)
        return x + xc @ self.proj_out.to(cd)

    def forward(self, x: Tensor, x0: Tensor, positions: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Full-sequence site (B, S, D) → (x', k, v)."""
        xc = torch.cat([x, x0], dim=-1)
        q, k, v = self.qkv(xc, positions)
        return self.finish(x, xc, transformer.causal_attention(self.cfg, q, k, v)), k, v


class Zamba(mamba2.Mamba2):
    """The Zamba-2 LM: :class:`~repro_torch.models.mamba2.Mamba2`'s
    embedding, final norm, head and blocks, and the shared block.
    ``forward`` gives every position's logits; ``prefill`` the last
    position's logits and a decode-ready cache; ``decode_step`` one
    token.  Weights come from :func:`init_params` or
    ``repro_torch.interop.zamba_params_from_numpy``."""

    def __init__(self, cfg: ZambaConfig, device):
        if cfg.n_layers % cfg.shared_every:
            raise ValueError(
                f"n_layers={cfg.n_layers} is not a whole number of segments of {cfg.shared_every}"
            )
        super().__init__(cfg, device)
        self.shared = SharedAttentionBlock(cfg, device)

    def _embed(self, tokens: Tensor) -> Tensor:
        return self.embed.to(self.cfg.compute_dtype)[tokens]

    def _positions(self, B: int, S: int, start: int = 0) -> Tensor:
        pos = torch.arange(start, start + S, device=self.embed.device)
        return pos[None].expand(B, S)

    def _segment(self, s: int):
        """Segment s's Mamba layers, in order."""
        E = self.cfg.shared_every
        return self.layers[s * E : (s + 1) * E]

    def forward(self, tokens: Tensor) -> Tensor:
        """tokens (B, S) → logits (B, S, vocab)."""
        x0 = self._embed(tokens)
        positions = self._positions(*tokens.shape)
        x = x0

        def layer(x, block):
            return block(x)[0]

        layer = common.remat(self.cfg, layer)
        for s in range(self.cfg.n_segments):
            x, _, _ = self.shared(x, x0, positions)
            for block in self._segment(s):
                x = layer(x, block)
        return self._head(x)

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zero cache of ``max_len`` K/V positions per site, length 0."""
        cfg = self.cfg
        Sg, E = cfg.n_segments, cfg.shared_every
        dev, cd = self.embed.device, cfg.compute_dtype
        kv = (Sg, batch, max_len, cfg.attn_kv_heads, cfg.attn_head_dim)
        return {
            "attn_k": torch.zeros(kv, dtype=cd, device=dev),
            "attn_v": torch.zeros(kv, dtype=cd, device=dev),
            "conv": torch.zeros(
                (Sg, E, batch, cfg.d_conv - 1, cfg.conv_dim), dtype=cd, device=dev
            ),
            "ssm": torch.zeros(
                (Sg, E, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_state),
                dtype=torch.float32, device=dev,
            ),
            "x0": torch.zeros((batch, 1, cfg.d_model), dtype=cd, device=dev),
            "length": 0,
        }

    def prefill(self, tokens: Tensor, max_len: int | None = None):
        """Run the full prompt (B, S): last logits (B, vocab) and a cache
        of ``max_len`` (default S) K/V positions per site holding the
        prompt's, with every Mamba layer's states after it."""
        B, S = tokens.shape
        M = max_len or S
        if M < S:
            raise ValueError(f"max_len={M} cannot hold a prompt of {S} tokens")
        cache = self.init_cache(B, M)
        x0 = self._embed(tokens)
        positions = self._positions(B, S)
        x = x0
        for s in range(self.cfg.n_segments):
            x, k, v = self.shared(x, x0, positions)
            cache["attn_k"][s, :, :S] = k
            cache["attn_v"][s, :, :S] = v
            for e, block in enumerate(self._segment(s)):
                x, (conv_st, ssm_st) = block(x)
                cache["conv"][s, e] = conv_st
                cache["ssm"][s, e] = ssm_st
        cache["x0"].copy_(x0[:, -1:])
        cache["length"] = S
        return self._head(x[:, -1:])[:, 0], cache

    def decode_step(self, cache: dict, tokens: Tensor):
        """One token per row, tokens (B, 1) → (logits (B, vocab), cache).

        Each site attends with the current token's embedding as x0, as
        the reference does.  Writes the new K/V at position
        ``cache["length"]`` and every layer's new states into ``cache``'s
        tensors in place and returns the cache with the length advanced;
        raises a ``ValueError`` when that position lies past the cache."""
        pos = cache["length"]
        M = cache["attn_k"].shape[2]
        if pos >= M:
            raise ValueError(
                f"KV cache full: decode position {pos} needs max_len > {pos}, the cache has {M}"
            )
        B = tokens.shape[0]
        x0 = self._embed(tokens)
        positions = self._positions(B, 1, pos)
        kv_len = torch.full((B,), pos + 1, device=x0.device)
        x = x0
        for s in range(self.cfg.n_segments):
            xc = torch.cat([x, x0], dim=-1)
            q, k, v = self.shared.qkv(xc, positions)
            cache["attn_k"][s, :, pos] = k[:, 0]
            cache["attn_v"][s, :, pos] = v[:, 0]
            attn = common.decode_attention(q, cache["attn_k"][s], cache["attn_v"][s], kv_len)
            x = self.shared.finish(x, xc, attn)
            for e, block in enumerate(self._segment(s)):
                x, conv_st, ssm_st = block.decode(x, cache["conv"][s, e], cache["ssm"][s, e])
                cache["conv"][s, e] = conv_st
                cache["ssm"][s, e] = ssm_st
        return self._head(x)[:, 0], {**cache, "length": pos + 1}


loss_fn = transformer.loss_fn  # the cross-entropy of forward's logits


@torch.no_grad()
def init_params(
    cfg: ZambaConfig, generator: torch.Generator | None = None, device=None
) -> Zamba:
    """A randomly initialised :class:`Zamba` on ``device`` (None = the
    card), with the reference's init distributions (the Mamba-2 backbone's
    as :func:`mamba2.init_params` draws them; truncated normal, std
    1/sqrt(fan_in), and ones for the norms of the shared block) drawn from
    ``generator`` (default: seed 0 on the target device)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device).manual_seed(0)
    model = Zamba(cfg, device)
    mamba2.fill_params(model, cfg, g)
    for name, shape in shared_shapes(cfg).items():
        p = getattr(model.shared, name)
        if name in ("ln1", "ln2"):
            p.fill_(1.0)
        else:
            p.copy_(common.dense_init(g, shape, cfg.param_dtype).to(p.device))
    return model
