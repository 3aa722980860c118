"""DeepSeek-V2(-Lite): Multi-head Latent Attention + DeepSeekMoE (port of
``repro.models.mla``).

MLA compresses K/V into a shared low-rank latent c_kv (``kv_lora``) plus
one shared RoPE key head (``qk_rope``); the decode cache stores only
(c_kv, k_rope), ``kv_lora + qk_rope`` values per position and layer.
Two attention paths, as the reference's:

* **prefill / forward**: decompress K and V per head (k_nope from c_kv,
  the shared k_rope broadcast to every head) and run the plain
  :func:`common.blockwise_attention` on (H, qk_nope + qk_rope)-dim keys
  at scale 1/sqrt(qk_dim), the reference's own computation (kernel B6
  has no build for a q·k dim of 192 beside a v dim of 128);
* **decode**: weight-absorbed latent attention: q_nope is pulled through
  W_uk into the latent space, scores and context are taken there in
  float32 against the cached c_kv, and the context is decompressed
  through W_uv after the softmax.

The FFN stack is DeepSeekMoE: ``first_k_dense`` leading layers with a
SwiGLU FFN, then layers with :func:`repro_torch.models.moe.moe_block`
(routed and shared experts), each under ``ln2``.

:class:`MLA` holds the embedding, the final norm, the untied head and
two ``nn.ModuleList`` of :class:`MLALayer` (``dense_layers`` and
``layers``; the reference stacks each and scans).  Its cache keeps the
reference's keys and shapes (``ckv_dense``, ``kr_dense``, ``ckv_moe``,
``kr_moe`` (layers, B, max_len, ·) in the compute dtype, and the filled
``length``); decode writes in place and raises a ``ValueError`` at
position ``max_len`` (the reference clamps the write onto the last
slot), and ``prefill`` raises when ``max_len`` is shorter than the
prompt.  Parameters are made without ``requires_grad`` (a trainer
turns it on); :func:`loss_fn` is the MoE family's (the cross-entropy
plus ``router_aux_coef`` × the aux), each layer rematerialised by
``cfg.remat_policy``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models import common, moe, transformer

Tensor = torch.Tensor

NORMS = ("ln1", "kv_ln", "ln2")


@dataclasses.dataclass(frozen=True)
class MLAConfig(moe.MoEConfig):
    family: str = "moe"
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128

    @property
    def qk_dim(self) -> int:
        return self.qk_nope + self.qk_rope

    def _count(self, experts: int) -> int:
        """Parameters with ``experts`` routed experts a MoE layer."""
        D, V, H = self.d_model, self.vocab, self.n_heads
        attn = (
            D * H * self.qk_dim  # wq
            + D * (self.kv_lora + self.qk_rope)  # w_dkv
            + self.kv_lora * H * (self.qk_nope + self.v_dim)  # w_ukv
            + H * self.v_dim * D  # wo
        )
        moe_p = experts * 3 * D * self.moe_d_ff + D * self.n_experts
        moe_p += 3 * D * self.moe_d_ff * self.n_shared_experts
        dense_l = attn + 3 * D * self.d_ff + 2 * D
        moe_l = attn + moe_p + 2 * D
        emb = V * D * (1 if self.tie_embeddings else 2)
        n_moe = self.n_layers - self.first_k_dense
        return self.first_k_dense * dense_l + n_moe * moe_l + emb + D


def attn_shapes(cfg: MLAConfig) -> dict[str, tuple[int, ...]]:
    """The shape of each attention parameter (the reference's ``_attn_init``)."""
    D, H = cfg.d_model, cfg.n_heads
    return {
        "ln1": (D,),
        "wq": (D, H * cfg.qk_dim),
        "w_dkv": (D, cfg.kv_lora + cfg.qk_rope),
        "kv_ln": (cfg.kv_lora,),
        "w_ukv": (cfg.kv_lora, H * (cfg.qk_nope + cfg.v_dim)),
        "wo": (H * cfg.v_dim, D),
    }


class MLAAttention(nn.Module):
    """MLA's attention parameters (``ln1``, ``wq``, ``w_dkv``, ``kv_ln``,
    ``w_ukv``, ``wo``) and its two paths."""

    def shapes(self, cfg: MLAConfig) -> dict[str, tuple[int, ...]]:
        return attn_shapes(cfg)

    def __init__(self, cfg: MLAConfig, device):
        super().__init__()
        self.cfg = cfg
        for name, shape in self.shapes(cfg).items():
            setattr(self, name, transformer._param(shape, cfg.param_dtype, device))

    def project(self, x: Tensor, positions: Tensor):
        """x (B, S, D) → q_nope (B, S, H, nope), q_rope (B, S, H, rope)
        with RoPE, c_kv (B, S, kv_lora) normed by ``kv_ln``, and the
        shared k_rope (B, S, rope) with RoPE."""
        cfg = self.cfg
        B, S, _ = x.shape
        cd = cfg.compute_dtype
        h = common.rms_norm(x, self.ln1, cfg.norm_eps)
        q = (h @ self.wq.to(cd)).reshape(B, S, cfg.n_heads, cfg.qk_dim)
        q_nope, q_rope = q[..., : cfg.qk_nope], q[..., cfg.qk_nope :]
        q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
        dkv = h @ self.w_dkv.to(cd)  # (B, S, kv_lora + qk_rope)
        c_kv = common.rms_norm(dkv[..., : cfg.kv_lora], self.kv_ln, cfg.norm_eps)
        k_rope = common.apply_rope(dkv[..., cfg.kv_lora :][:, :, None, :], positions, cfg.rope_theta)
        return q_nope, q_rope, c_kv, k_rope[:, :, 0]

    def full(self, x: Tensor, positions: Tensor) -> tuple[Tensor, tuple[Tensor, Tensor]]:
        """Full-sequence path: x + attention, and (c_kv, k_rope) for the cache."""
        cfg = self.cfg
        B, S, _ = x.shape
        H = cfg.n_heads
        cd = cfg.compute_dtype
        q_nope, q_rope, c_kv, k_rope = self.project(x, positions)
        ukv = (c_kv @ self.w_ukv.to(cd)).reshape(B, S, H, cfg.qk_nope + cfg.v_dim)
        k_nope, v = ukv[..., : cfg.qk_nope], ukv[..., cfg.qk_nope :]
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, cfg.qk_rope)], dim=-1)
        attn = common.blockwise_attention(
            q, k, v, causal=True, block_k=cfg.block_k, softmax_scale=1.0 / math.sqrt(cfg.qk_dim)
        )
        o = attn.reshape(B, S, H * cfg.v_dim) @ self.wo.to(cd)
        return x + constrain(o, ("batch", None, None)), (c_kv, k_rope)

    def decode(self, x: Tensor, pos: int, ckv_c: Tensor, kr_c: Tensor) -> Tensor:
        """Absorbed decode of one token per row at position ``pos``: writes
        its c_kv and k_rope into the caches ``ckv_c`` (B, M, kv_lora) and
        ``kr_c`` (B, M, rope) in place and attends over positions <= pos
        in the latent space, in float32."""
        cfg = self.cfg
        B = x.shape[0]
        H = cfg.n_heads
        cd = cfg.compute_dtype
        M = ckv_c.shape[1]
        positions = torch.full((B, 1), pos, device=x.device)
        q_nope, q_rope, c_kv, k_rope = self.project(x, positions)
        ckv_c[:, pos] = c_kv[:, 0]
        kr_c[:, pos] = k_rope[:, 0]

        w_ukv = self.w_ukv.to(cd).reshape(cfg.kv_lora, H, cfg.qk_nope + cfg.v_dim)
        w_uk, w_uv = w_ukv[..., : cfg.qk_nope], w_ukv[..., cfg.qk_nope :]  # (Z, H, ·)
        q_lat = torch.einsum("bqhd,zhd->bqhz", q_nope, w_uk)  # q in the latent space
        ckv = ckv_c.float()
        s = torch.einsum("bqhz,bmz->bhqm", q_lat.float(), ckv)
        s = s + torch.einsum("bqhd,bmd->bhqm", q_rope.float(), kr_c.float())
        s = s * (1.0 / math.sqrt(cfg.qk_dim))
        valid = torch.arange(M, device=x.device) <= pos
        s = torch.where(valid, s, common.NEG)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhqm,bmz->bqhz", p, ckv)
        v_ctx = torch.einsum("bqhz,zhd->bqhd", ctx, w_uv.float()).to(cd)
        return x + v_ctx.reshape(B, 1, H * cfg.v_dim) @ self.wo.to(cd)


class MLALayer(MLAAttention):
    """One DeepSeek layer: MLA attention, then under ``ln2`` a SwiGLU FFN
    (``w_gate``, ``w_up``, ``w_down``; a dense layer) or the MoE block
    (``moe``)."""

    def __init__(self, cfg: MLAConfig, device, is_moe: bool):
        self.is_moe = is_moe
        super().__init__(cfg, device)
        if is_moe:
            self.moe = moe.MoEParams(cfg, device)

    def shapes(self, cfg: MLAConfig) -> dict[str, tuple[int, ...]]:
        shapes = {**attn_shapes(cfg), "ln2": (cfg.d_model,)}
        if not self.is_moe:
            D, F = cfg.d_model, cfg.d_ff
            shapes.update(w_gate=(D, F), w_up=(D, F), w_down=(F, D))
        return shapes

    def ffn(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """x → (x + FFN(ln2(x)), aux); aux is 0 in a dense layer."""
        cfg = self.cfg
        h = common.rms_norm(x, self.ln2, cfg.norm_eps)
        if self.is_moe:
            y, aux = moe.moe_block(cfg, self.moe, h)
        else:
            cd = cfg.compute_dtype
            y = common.swiglu(h @ self.w_gate.to(cd), h @ self.w_up.to(cd)) @ self.w_down.to(cd)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + y, aux


class MLA(nn.Module):
    """The DeepSeek-V2 LM.  ``forward`` gives every position's logits and
    the layers' aux summed over ``n_layers``; ``prefill`` the last
    position's logits and a latent cache; ``decode_step`` one token.
    Weights come from :func:`init_params` or
    ``repro_torch.interop.mla_params_from_numpy``."""

    def __init__(self, cfg: MLAConfig, device):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embed = transformer._param((cfg.vocab, cfg.d_model), pd, device)
        self.final_norm = transformer._param((cfg.d_model,), pd, device)
        self.lm_head = transformer._param((cfg.d_model, cfg.vocab), pd, device)
        self.dense_layers = nn.ModuleList(
            MLALayer(cfg, device, False) for _ in range(cfg.first_k_dense)
        )
        self.layers = nn.ModuleList(
            MLALayer(cfg, device, True) for _ in range(cfg.n_layers - cfg.first_k_dense)
        )

    def _stacks(self):
        """(cache key suffix, layers): the dense stack, then the MoE stack."""
        return (("dense", self.dense_layers), ("moe", self.layers))

    def _embed(self, tokens: Tensor) -> Tensor:
        return self.embed.to(self.cfg.compute_dtype)[tokens]

    def _head(self, x: Tensor) -> Tensor:
        cfg = self.cfg
        x = common.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x @ self.lm_head.to(cfg.compute_dtype)

    def _positions(self, B: int, S: int) -> Tensor:
        return torch.arange(S, device=self.embed.device)[None].expand(B, S)

    def forward(self, tokens: Tensor) -> tuple[Tensor, Tensor]:
        """tokens (B, S) → (logits (B, S, vocab), Σ aux / n_layers)."""
        x = constrain(self._embed(tokens), ("batch", None, None))
        positions = self._positions(*tokens.shape)

        def layer(x, blk):
            return blk.ffn(blk.full(x, positions)[0])

        layer = common.remat(self.cfg, layer)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for _, stack in self._stacks():
            for blk in stack:
                x, a = layer(x, blk)
                aux = aux + a
        return constrain(self._head(x), ("batch", None, "vocab")), aux / self.cfg.n_layers

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zero latent cache of ``max_len`` positions, length 0."""
        cfg = self.cfg
        dev, cd = self.embed.device, cfg.compute_dtype
        cache = {}
        for name, stack in self._stacks():
            if len(stack):
                L = len(stack)
                cache[f"ckv_{name}"] = torch.zeros((L, batch, max_len, cfg.kv_lora), dtype=cd, device=dev)
                cache[f"kr_{name}"] = torch.zeros((L, batch, max_len, cfg.qk_rope), dtype=cd, device=dev)
        cache["length"] = 0
        return cache

    def prefill(self, tokens: Tensor, max_len: int | None = None):
        """Run the full prompt (B, S): last logits (B, vocab) and a cache
        of ``max_len`` (default S) positions holding the prompt's latents."""
        B, S = tokens.shape
        M = max_len or S
        if M < S:
            raise ValueError(f"max_len={M} cannot hold a prompt of {S} tokens")
        cache = self.init_cache(B, M)
        x = constrain(self._embed(tokens), ("batch", None, None))
        positions = self._positions(B, S)
        for name, stack in self._stacks():
            for i, blk in enumerate(stack):
                x, (c_kv, k_rope) = blk.full(x, positions)
                x, _ = blk.ffn(x)
                cache[f"ckv_{name}"][i, :, :S] = c_kv
                cache[f"kr_{name}"][i, :, :S] = k_rope
        cache["length"] = S
        return self._head(x[:, -1:])[:, 0], cache

    def decode_step(self, cache: dict, tokens: Tensor):
        """One token per row, tokens (B, 1) → (logits (B, vocab), cache).

        Writes the new latents into ``cache``'s tensors in place at
        position ``cache["length"]`` and returns the cache with the length
        advanced; raises a ``ValueError`` when that position lies past the
        cache."""
        pos = cache["length"]
        M = cache["ckv_moe"].shape[2]
        if pos >= M:
            raise ValueError(
                f"KV cache full: decode position {pos} needs max_len > {pos}, the cache has {M}"
            )
        x = self._embed(tokens)
        for name, stack in self._stacks():
            for i, blk in enumerate(stack):
                x = blk.decode(x, pos, cache[f"ckv_{name}"][i], cache[f"kr_{name}"][i])
                x, _ = blk.ffn(x)
        return self._head(x)[:, 0], {**cache, "length": pos + 1}


loss_fn = moe.loss_fn  # cross-entropy + router_aux_coef × aux

# each attention parameter's and cache tensor's logical axes, as the
# reference's ``init_params`` and ``init_cache`` give them
ATTN_AXES = {
    "ln1": (None,), "wq": ("embed", "heads"), "w_dkv": ("embed", "kv_lora"),
    "kv_ln": (None,), "w_ukv": ("kv_lora", "heads"), "wo": ("heads", "embed"),
}
_LATENT_AXES = ("layers", "batch", "kv_seq", None)
CACHE_AXES = {
    "ckv_moe": _LATENT_AXES, "kr_moe": _LATENT_AXES,
    "ckv_dense": _LATENT_AXES, "kr_dense": _LATENT_AXES,
    "length": (),
}


def logical_axes(cfg: MLAConfig) -> dict:
    """Every parameter's logical axes in the reference's tree: ``embed``,
    ``final_norm``, ``lm_head``, the stacked ``dense_layers`` (with
    ``first_k_dense``) and the stacked MoE ``layers``."""
    dense = {n: transformer.LAYER_AXES[n] for n in ("ln2", "w_gate", "w_up", "w_down")}
    axes = {"embed": ("vocab", "embed"), "final_norm": (None,), "lm_head": ("embed", "vocab"),
            "layers": common.stacked_axes({**ATTN_AXES, "ln2": (None,), "moe": moe.moe_axes(cfg)})}
    if cfg.first_k_dense:
        axes["dense_layers"] = common.stacked_axes({**ATTN_AXES, **dense})
    return axes


@torch.no_grad()
def init_params(cfg: MLAConfig, generator: torch.Generator | None = None, device=None) -> MLA:
    """A randomly initialised :class:`MLA` on ``device`` (None = the
    card), with the reference's init distributions (truncated normal,
    std 1/sqrt(fan_in), embedding std 0.02, ones for the norms; the MoE
    by :func:`moe.fill_moe`) drawn from ``generator`` (default: seed 0 on
    the target device)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device).manual_seed(0)
    model = MLA(cfg, device)
    pd = cfg.param_dtype

    def put(p: nn.Parameter, value: Tensor) -> None:
        p.copy_(value.to(device=p.device, dtype=p.dtype))

    put(model.embed, common.dense_init(g, (cfg.vocab, cfg.d_model), pd, 0.02))
    put(model.final_norm, common.ones_init((cfg.d_model,), pd))
    put(model.lm_head, common.dense_init(g, (cfg.d_model, cfg.vocab), pd))
    for _, stack in model._stacks():
        for blk in stack:
            for name, shape in blk.shapes(cfg).items():
                value = common.ones_init(shape, pd) if name in NORMS else common.dense_init(g, shape, pd)
                put(getattr(blk, name), value)
            if blk.is_moe:
                moe.fill_moe(blk.moe, cfg, g)
    return model
