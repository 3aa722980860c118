"""Whisper-tiny backbone (port of ``repro.models.whisper``): a transformer
encoder–decoder.

The conv / mel frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings ``frames`` (B, n_frames, d_model), to which
the encoder adds the sinusoidal table, beside the decoder's ``tokens``
(B, S).  LayerNorm, GELU (the tanh approximation, ``jax.nn.gelu``'s
default), learned decoder positions, tied unembedding.  Attention
projections carry biases on q, v and the output; k has none.

:class:`Whisper` is an ``nn.Module`` whose parameters keep the
reference's tree names: ``embed``, ``dec_pos``, ``enc_ln_post`` and
``dec_ln_post`` (each ``{w, b}``), ``enc_layers[i]`` ``{ln1, attn, ln2,
mlp}`` and ``dec_layers[i]`` ``{ln1, self_attn, ln2, cross_attn, ln3,
mlp}``, attention ``{wq, wk, wv, wo, bq, bv, bo}``, mlp ``{w1, b1, w2,
b2}``, weights in the reference's ``x @ w`` orientation.  Parameters
are made without ``requires_grad`` (a trainer turns it on);
:func:`loss_fn` is the cross-entropy of ``forward``'s logits, each
encoder and decoder layer rematerialised by ``cfg.remat_policy``.

Attention of a full sequence goes through
:func:`repro_torch.models.transformer.attention` by ``cfg.attn_impl``:
``'kernel'`` (B6 on the card, its plain version on the CPU) or
``'blockwise'``.  A prefill runs it three ways per layer: the encoder
(full, T × T), the decoder's self attention (causal, S × S) and its
cross attention (full, S × T); with a one-token prompt the cross
attention takes ``decode_attention``, as the reference's
``_mha_cached`` does.  Decode attends through ``decode_attention`` only.

The cache holds ``self_k`` and ``self_v`` of (L, B, M, H, hd), written in
place, ``cross_k`` and ``cross_v`` of (L, B, T, H, hd), fixed at
prefill, and ``length``.  Where the reference clamps silently (the
``[:S]`` slice of ``dec_pos``, ``dynamic_slice`` and
``dynamic_update_slice`` in decode) the port raises a ``ValueError``: a
prompt or decode position at or past ``max_target``, or a decode
position at or past the cache's M.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import common, transformer

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class WhisperConfig(transformer.TransformerConfig):
    family: str = "audio"
    n_frames: int = 1500  # encoder positions (30 s @ 50 Hz)
    max_target: int = 4096  # decoder learned-position table
    tie_embeddings: bool = True

    def num_params(self) -> int:
        D, F, V, H, hd = self.d_model, self.d_ff, self.vocab, self.n_heads, self.hd
        attn = 4 * D * H * hd
        mlp = 2 * D * F
        enc_l = attn + mlp + 4 * D
        dec_l = 2 * attn + mlp + 6 * D
        return self.n_layers * (enc_l + dec_l) + V * D + self.max_target * D + 4 * D


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class LayerNorm(nn.Module):
    """``{w, b}`` of one LayerNorm."""

    def __init__(self, cfg: WhisperConfig, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.w = _param((cfg.d_model,), cfg.param_dtype, device)
        self.b = _param((cfg.d_model,), cfg.param_dtype, device)

    def forward(self, x: Tensor) -> Tensor:
        return common.layer_norm(x, self.w, self.b, self.eps)


class Attention(nn.Module):
    """Multi-head attention projections with Whisper's biases (q, v and
    the output; none on k)."""

    def __init__(self, cfg: WhisperConfig, device):
        super().__init__()
        self.cfg = cfg
        D, Hd, pd = cfg.d_model, cfg.n_heads * cfg.hd, cfg.param_dtype
        for name, shape in (("wq", (D, Hd)), ("wk", (D, Hd)), ("wv", (D, Hd)), ("wo", (Hd, D)),
                            ("bq", (Hd,)), ("bv", (Hd,)), ("bo", (D,))):
            setattr(self, name, _param(shape, pd, device))

    def _heads(self, x: Tensor) -> Tensor:
        return x.reshape(x.shape[0], x.shape[1], self.cfg.n_heads, self.cfg.hd)

    def q(self, x: Tensor) -> Tensor:
        """x (B, S, D) → q (B, S, H, hd)."""
        cd = self.cfg.compute_dtype
        return self._heads(x @ self.wq.to(cd) + self.bq.to(cd))

    def kv(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """x (B, S, D) → k, v (B, S, H, hd) (the reference's ``_kv``)."""
        cd = self.cfg.compute_dtype
        return self._heads(x @ self.wk.to(cd)), self._heads(x @ self.wv.to(cd) + self.bv.to(cd))

    def out(self, o: Tensor) -> Tensor:
        """Attention output (B, S, H, hd) → (B, S, D)."""
        cd = self.cfg.compute_dtype
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.to(cd) + self.bo.to(cd)

    def full(self, xq: Tensor, xkv: Tensor, causal: bool) -> Tensor:
        """Attention of xq over all of xkv (the reference's ``_mha``)."""
        k, v = self.kv(xkv)
        return self.out(transformer.attention(self.cfg, self.q(xq), k, v, causal))


class MLP(nn.Module):
    """``{w1, b1, w2, b2}``: GELU between two biased projections."""

    def __init__(self, cfg: WhisperConfig, device):
        super().__init__()
        self.cfg = cfg
        D, F, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.w1 = _param((D, F), pd, device)
        self.b1 = _param((F,), pd, device)
        self.w2 = _param((F, D), pd, device)
        self.b2 = _param((D,), pd, device)

    def forward(self, x: Tensor) -> Tensor:
        cd = self.cfg.compute_dtype
        h = common._gelu(x @ self.w1.to(cd) + self.b1.to(cd))
        return h @ self.w2.to(cd) + self.b2.to(cd)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln2 = LayerNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: Tensor) -> Tensor:
        h = self.ln1(x)
        x = x + self.attn.full(h, h, causal=False)
        return x + self.mlp(self.ln2(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg, device)
        self.self_attn = Attention(cfg, device)
        self.ln2 = LayerNorm(cfg, device)
        self.cross_attn = Attention(cfg, device)
        self.ln3 = LayerNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def finish(self, x: Tensor, attn: Tensor) -> Tensor:
        """After the cross attention's output: the MLP and its residual."""
        x = x + attn
        return x + self.mlp(self.ln3(x))


class Whisper(nn.Module):
    """The encoder–decoder.  ``encode`` maps frames to the encoder
    output; ``forward`` gives every decoder position's logits (teacher
    forced); ``prefill`` the last position's logits and a decode-ready
    cache; ``decode_step`` one token.  Weights come from
    :func:`init_params` or ``repro_torch.interop.whisper_params_from_numpy``."""

    def __init__(self, cfg: WhisperConfig, device):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), pd, device)
        self.dec_pos = _param((cfg.max_target, cfg.d_model), pd, device)
        self.enc_ln_post = LayerNorm(cfg, device)
        self.dec_ln_post = LayerNorm(cfg, device)
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, device) for _ in range(cfg.n_layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, device) for _ in range(cfg.n_layers))

    def _check_target(self, end: int) -> None:
        if end > self.cfg.max_target:
            raise ValueError(
                f"decoder position {end - 1} lies past the position table: max_target="
                f"{self.cfg.max_target}"
            )

    def encode(self, frames: Tensor) -> Tensor:
        """frames (B, T, D), precomputed embeddings → encoder output (B, T, D)."""
        cd = self.cfg.compute_dtype
        T, D = frames.shape[1:]
        pe = common.sinusoidal_positions(T, D, device=self.embed.device)
        x = frames.to(device=self.embed.device, dtype=cd) + pe.to(cd)[None]  # an add in cd
        layer_fn = common.remat(self.cfg, lambda x, layer: layer(x))
        for layer in self.enc_layers:
            x = layer_fn(x, layer)
        return self.enc_ln_post(x)

    def _decoder_input(self, tokens: Tensor, start: int) -> Tensor:
        S = tokens.shape[1]
        self._check_target(start + S)
        cd = self.cfg.compute_dtype
        return self.embed.to(cd)[tokens] + self.dec_pos.to(cd)[start : start + S][None]

    def _logits(self, x: Tensor) -> Tensor:
        return self.dec_ln_post(x) @ self.embed.to(self.cfg.compute_dtype).T  # tied

    def forward(self, batch: dict) -> Tensor:
        """batch {frames (B, T, D), tokens (B, S)} → logits (B, S, vocab)."""
        enc = self.encode(batch["frames"])
        x = self._decoder_input(batch["tokens"], 0)

        def layer_fn(x, enc, layer):
            h = layer.ln1(x)
            x = x + layer.self_attn.full(h, h, causal=True)
            return layer.finish(x, layer.cross_attn.full(layer.ln2(x), enc, causal=False))

        layer_fn = common.remat(self.cfg, layer_fn)
        for layer in self.dec_layers:
            x = layer_fn(x, enc, layer)
        return self._logits(x)

    def _cache(self, batch: int, max_len: int, frames: int) -> dict:
        cfg = self.cfg
        dev, cd = self.embed.device, cfg.compute_dtype
        self_shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.hd)
        cross_shape = (cfg.n_layers, batch, frames, cfg.n_heads, cfg.hd)
        return {
            "self_k": torch.zeros(self_shape, dtype=cd, device=dev),
            "self_v": torch.zeros(self_shape, dtype=cd, device=dev),
            "cross_k": torch.zeros(cross_shape, dtype=cd, device=dev),
            "cross_v": torch.zeros(cross_shape, dtype=cd, device=dev),
            "length": 0,
        }

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zero cache: self K/V of ``max_len`` positions, cross K/V of
        ``n_frames``, length 0."""
        return self._cache(batch, max_len, self.cfg.n_frames)

    def prefill(self, batch: dict, max_len: int | None = None):
        """Encode the frames and run the decoder prompt (B, S): last logits
        (B, vocab) and a cache of ``max_len`` (default S) self positions
        and the T frames' cross K/V."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        M = max_len or S
        if M < S:
            raise ValueError(f"max_len={M} cannot hold a prompt of {S} tokens")
        cfg = self.cfg
        enc = self.encode(batch["frames"])
        x = self._decoder_input(tokens, 0)
        T = enc.shape[1]
        cache = self._cache(B, M, T)
        full_T = torch.full((B,), T, device=x.device)
        for i, layer in enumerate(self.dec_layers):
            h = layer.ln1(x)
            k, v = layer.self_attn.kv(h)
            q = layer.self_attn.q(h)
            x = x + layer.self_attn.out(transformer.attention(cfg, q, k, v, True))
            cache["self_k"][i, :, :S] = k
            cache["self_v"][i, :, :S] = v
            h = layer.ln2(x)
            ck, cv = layer.cross_attn.kv(enc)
            q = layer.cross_attn.q(h)
            if S == 1:  # the reference's single-query branch of _mha_cached
                o = common.decode_attention(q, ck, cv, full_T)
            else:
                o = transformer.attention(cfg, q, ck, cv, False)
            x = layer.finish(x, layer.cross_attn.out(o))
            cache["cross_k"][i] = ck
            cache["cross_v"][i] = cv
        cache["length"] = S
        return self._logits(x[:, -1:])[:, 0], cache

    def decode_step(self, cache: dict, tokens: Tensor):
        """One token per row, tokens (B, 1) → (logits (B, vocab), cache).

        Writes the new self K/V into ``cache``'s tensors in place at
        position ``cache["length"]`` and returns the cache with the length
        advanced; raises a ``ValueError`` when that position lies past the
        cache or past ``max_target``."""
        pos = cache["length"]
        M = cache["self_k"].shape[2]
        if pos >= M:
            raise ValueError(
                f"KV cache full: decode position {pos} needs max_len > {pos}, the cache has {M}"
            )
        B = tokens.shape[0]
        x = self._decoder_input(tokens, pos)
        kv_len = torch.full((B,), pos + 1, device=x.device)
        full_T = torch.full((B,), cache["cross_k"].shape[2], device=x.device)
        for i, layer in enumerate(self.dec_layers):
            h = layer.ln1(x)
            k, v = layer.self_attn.kv(h)
            cache["self_k"][i, :, pos] = k[:, 0]
            cache["self_v"][i, :, pos] = v[:, 0]
            o = common.decode_attention(
                layer.self_attn.q(h), cache["self_k"][i], cache["self_v"][i], kv_len
            )
            x = x + layer.self_attn.out(o)
            q = layer.cross_attn.q(layer.ln2(x))
            o = common.decode_attention(q, cache["cross_k"][i], cache["cross_v"][i], full_T)
            x = layer.finish(x, layer.cross_attn.out(o))
        return self._logits(x)[:, 0], {**cache, "length": pos + 1}


def loss_fn(cfg: WhisperConfig, model: nn.Module, batch: dict) -> Tensor:
    """The mean cross-entropy of the decoder's logits on ``batch``
    (``frames``, ``tokens``) against ``batch["labels"]``."""
    logits = model(batch)
    return common.softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))


def fill_params(model: Whisper, cfg: WhisperConfig, g: torch.Generator) -> None:
    """Draw ``model``'s parameters from ``g`` with the reference's init
    distributions (truncated normal, std 1/sqrt(fan_in); embedding std
    0.02, decoder positions 0.01; ones and zeros for the LayerNorms, zeros
    for the biases)."""
    pd = cfg.param_dtype

    def put(p: nn.Parameter, value: Tensor) -> None:
        p.copy_(value.to(device=p.device, dtype=p.dtype))

    put(model.embed, common.dense_init(g, tuple(model.embed.shape), pd, 0.02))
    put(model.dec_pos, common.dense_init(g, tuple(model.dec_pos.shape), pd, 0.01))
    for name, p in model.named_parameters():
        if name in ("embed", "dec_pos"):
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w" and p.ndim == 1:  # a LayerNorm's scale
            put(p, common.ones_init(tuple(p.shape), pd))
        elif leaf.startswith("b"):
            put(p, common.zeros_init(tuple(p.shape), pd))
        else:
            put(p, common.dense_init(g, tuple(p.shape), pd))


@torch.no_grad()
def init_params(
    cfg: WhisperConfig, generator: torch.Generator | None = None, device=None
) -> Whisper:
    """A randomly initialised :class:`Whisper` on ``device`` (None = the
    card), drawn by :func:`fill_params` from ``generator`` (default: seed
    0 on the target device)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device).manual_seed(0)
    model = Whisper(cfg, device)
    fill_params(model, cfg, g)
    return model
