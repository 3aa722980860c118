"""Dense decoder-only transformer (granite, qwen2, llama3, nemotron; port
of ``repro.models.transformer``), and ``TransformerConfig``, the base
of the other families' configs.

The VLM (``models/vlm.py``) is this model over patch embeddings
prepended to the tokens.  One layer definition covers the dense family
through config switches: GQA kv-head count, QKV bias (qwen2), MLP
flavour (SwiGLU or nemotron's squared ReLU), RoPE theta, tied
embeddings.  ``remat`` and ``remat_policy`` are the reference's
(``common.remat``).  The layers name the reference's activation
constraints (``distributed.sharding.constrain``, at its sites), which
change no value.  Of the reference's four mesh knobs only
``seq_shard`` is here: it names the residual between layers
sequence-sharded over ``model``, which the dry run's collective plan
prices.  The dry run's variant keys of the other three parse and change
nothing (``launch.dryrun.NO_OP_KEYS``): ``lean_softmax`` is read by no
model code in the reference either, and ``fsdp_gather_weights`` and
``seq_gather_entry`` leave the reference's own collective bytes
unchanged or their sum within 1 % (``tests/test_torch_dryrun_mesh.py``).

:class:`Transformer` is an ``nn.Module`` holding its config, the
embedding, the final norm and an ``nn.ModuleList`` of
:class:`TransformerBlock` (the reference scans stacked layers instead),
with weights in the reference's ``x @ w`` orientation and names.  Its
parameters are made without ``requires_grad``, so a server holds no
graph; a trainer turns gradients on (``model.requires_grad_(True)``).
:func:`loss_fn` is the training objective: the cross-entropy of
``forward``'s logits, each block rematerialised in the backward by
``cfg.remat_policy``.

The KV cache is preallocated: ``k`` and ``v`` of (n_layers, B, M, G, hd)
in the compute dtype, and the filled ``length``.  Decode writes each
new position in place and attends over all M slots masked to
``length + 1``, as the reference does; a decode that would write at
position M raises a ``ValueError`` (the reference clamps the write onto
the last slot and answers wrongly).

``attn_impl`` picks the prefill attention route of :func:`attention`
(causal or full; :func:`causal_attention` is its causal call, the one
every decoder-only family takes).  ``'kernel'`` (the default) goes
through :func:`repro_torch.kernels.flash.ops.flash_attention`:
the hand-written CUDA kernel for CUDA tensors, its plain version for
CPU tensors.  ``'blockwise'`` runs the plain
:func:`common.blockwise_attention` on either device, the reference
transformer's own computation.  Decode attention is plain torch on both.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models import common

Tensor = torch.Tensor

# per-layer parameters, in the reference's names (the biases only with
# qkv_bias, w_gate only with the SwiGLU MLP)
LAYER_FIELDS = (
    "ln1", "wq", "wk", "wv", "wo", "ln2", "bq", "bk", "bv", "w_gate", "w_up", "w_down",
)
ATTN_IMPLS = ("kernel", "blockwise")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "transformer"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int | None = None
    mlp: str = "swiglu"  # 'swiglu' | 'squared_relu' | 'gelu'
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    block_k: int = 512
    remat_policy: str = "full"  # 'full' | 'dots' | 'none' (common.remat)
    attn_impl: str = "kernel"  # 'kernel' (flash ops) | 'blockwise' (plain)
    seq_shard: bool = False  # the residual between layers sequence-sharded over 'model'

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def num_params(self) -> int:
        D, F, V, H, G, hd = (
            self.d_model, self.d_ff, self.vocab, self.n_heads, self.n_kv_heads, self.hd,
        )
        attn = D * H * hd + 2 * D * G * hd + H * hd * D
        mlp = 3 * D * F if self.mlp == "swiglu" else 2 * D * F
        per_layer = attn + mlp + 2 * D
        emb = V * D * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + D


def attention(cfg: TransformerConfig, q: Tensor, k: Tensor, v: Tensor, causal: bool) -> Tensor:
    """Attention of q (B, Sq, H, hd) over all of k, v (B, Sk, G, hd) by
    ``cfg.attn_impl``; ``causal`` masks top-left aligned (query i sees
    keys up to i)."""
    if cfg.attn_impl == "kernel":
        return flash_ops.flash_attention(q, k, v, causal)
    if cfg.attn_impl == "blockwise":
        return common.blockwise_attention(q, k, v, causal=causal, block_k=cfg.block_k)
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; expected one of {ATTN_IMPLS}")


def causal_attention(cfg: TransformerConfig, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal attention of a full sequence by ``cfg.attn_impl``."""
    return attention(cfg, q, k, v, True)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def layer_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    """The shape of each per-layer parameter this config has."""
    D, F, H, G, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {
        "ln1": (D,), "wq": (D, H * hd), "wk": (D, G * hd), "wv": (D, G * hd),
        "wo": (H * hd, D), "ln2": (D,),
    }
    if cfg.qkv_bias:
        shapes.update(bq=(H * hd,), bk=(G * hd,), bv=(G * hd,))
    if cfg.mlp == "swiglu":
        shapes["w_gate"] = (D, F)
    shapes.update(w_up=(D, F), w_down=(F, D))
    return shapes


# each parameter's logical axes, as the reference's ``init_params`` gives
# them (its second value), for the sharding rules
LAYER_AXES = {
    "ln1": (None,), "wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"), "ln2": (None,),
    "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",),
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed"),
}
# the decode cache's, by cache key (the reference's ``init_cache``)
KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", None)
CACHE_AXES = {"k": KV_AXES, "v": KV_AXES, "length": ()}


def outer_axes(cfg: TransformerConfig) -> dict[str, tuple]:
    """The axes of ``embed``, ``final_norm`` and (untied) ``lm_head``."""
    axes = {"embed": ("vocab", "embed"), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def logical_axes(cfg: TransformerConfig) -> dict:
    """Every parameter's logical axes in the reference's tree: the outer
    parameters, and ``layers`` with the fields ``cfg`` has, each leaf
    led by the stacked ``layers`` axis (the port's names come from
    ``launch.specs.params_logical_axes``)."""
    layer = {n: LAYER_AXES[n] for n in layer_shapes(cfg)}
    return {**outer_axes(cfg), "layers": common.stacked_axes(layer)}


class TransformerBlock(nn.Module):
    """One pre-norm residual layer: attention, then the MLP (the
    reference's ``_qkv``, ``_attn_out`` and ``_mlp``).  Its parameters
    are those ``shapes(cfg)`` names."""

    shapes = staticmethod(layer_shapes)

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        for name, shape in self.shapes(cfg).items():
            setattr(self, name, _param(shape, cfg.param_dtype, device))

    def qkv(self, x: Tensor, positions: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """x (B, S, D) → q (B, S, H, hd), k and v (B, S, G, hd), RoPE on q, k."""
        cfg = self.cfg
        B, S, _ = x.shape
        cd = cfg.compute_dtype
        h = common.rms_norm(x, self.ln1, cfg.norm_eps)
        q = h @ self.wq.to(cd)
        k = h @ self.wk.to(cd)
        v = h @ self.wv.to(cd)
        if cfg.qkv_bias:
            q = q + self.bq.to(cd)
            k = k + self.bk.to(cd)
            v = v + self.bv.to(cd)
        q = q.reshape(B, S, cfg.n_heads, cfg.hd)
        k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
        v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
        q = constrain(q, ("batch", None, "heads", None))
        k = constrain(k, ("batch", None, "kv_heads", None))
        return q, k, v

    def attn_out(self, x: Tensor, attn: Tensor) -> Tensor:
        """Output projection and its residual."""
        cfg = self.cfg
        B, S = x.shape[:2]
        o = attn.reshape(B, S, cfg.n_heads * cfg.hd) @ self.wo.to(cfg.compute_dtype)
        return x + constrain(o, ("batch", None, None))

    def mlp(self, x: Tensor) -> Tensor:
        """The MLP on ``ln2`` of x, and its residual."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        h = common.rms_norm(x, self.ln2, cfg.norm_eps)
        if cfg.mlp == "swiglu":
            z = common.swiglu(h @ self.w_gate.to(cd), h @ self.w_up.to(cd))
        else:
            z = common.ACTIVATIONS[cfg.mlp](h @ self.w_up.to(cd))
        z = constrain(z, ("batch", None, "mlp"))
        return x + z @ self.w_down.to(cd)

    def finish(self, x: Tensor, attn: Tensor) -> Tensor:
        """Output projection and residual, then the MLP and its residual."""
        return self.mlp(self.attn_out(x, attn))

    def forward(self, x: Tensor, positions: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Full-sequence layer (B, S, D) → (x', k, v)."""
        q, k, v = self.qkv(x, positions)
        return self.finish(x, causal_attention(self.cfg, q, k, v)), k, v


class Transformer(nn.Module):
    """The dense LM.  ``forward`` gives every position's logits;
    ``prefill`` the last position's logits and a decode-ready cache;
    ``decode_step`` one token.  Weights come from :func:`init_params` or
    ``repro_torch.interop.transformer_params_from_numpy``."""

    block = TransformerBlock  # the layer class

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), pd, device)
        self.final_norm = _param((cfg.d_model,), pd, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), pd, device)
        self.layers = nn.ModuleList(self.block(cfg, device) for _ in range(cfg.n_layers))

    def _embed(self, tokens: Tensor) -> Tensor:
        return self.embed.to(self.cfg.compute_dtype)[tokens]

    def _head(self, x: Tensor) -> Tensor:
        cfg = self.cfg
        x = common.rms_norm(x, self.final_norm, cfg.norm_eps)
        cd = cfg.compute_dtype
        head = self.embed.to(cd).T if cfg.tie_embeddings else self.lm_head.to(cd)
        return x @ head

    def _positions(self, B: int, S: int, start: int = 0) -> Tensor:
        pos = torch.arange(start, start + S, device=self.embed.device)
        return pos[None].expand(B, S)

    def forward(self, tokens: Tensor) -> Tensor:
        """tokens (B, S) → logits (B, S, vocab)."""
        return self._forward_embedded(self._embed(tokens))

    def _forward_embedded(self, x: Tensor) -> Tensor:
        """Every position's logits of embedded inputs x (B, S, D) at
        positions 0 … S − 1 (the reference's ``trunk`` and ``unembed``)."""
        x = constrain(x, ("batch", None, None))
        positions = self._positions(*x.shape[:2])
        seq_axis = "seq_model" if self.cfg.seq_shard else None

        def layer(x, block):
            return constrain(block(x, positions)[0], ("batch", seq_axis, None))

        layer = common.remat(self.cfg, layer)
        for block in self.layers:
            x = layer(x, block)
        return constrain(self._head(x), ("batch", None, "vocab"))

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zero K/V cache of ``max_len`` positions, length 0."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        dev, cd = self.embed.device, cfg.compute_dtype
        return {
            "k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev),
            "length": 0,
        }

    def prefill(self, tokens: Tensor, max_len: int | None = None):
        """Run the full prompt (B, S): last logits (B, vocab) and a cache
        of ``max_len`` (default S) positions holding the prompt's K/V."""
        return self._prefill_embedded(self._embed(tokens), max_len)

    def _prefill_embedded(self, x: Tensor, max_len: int | None):
        """Prefill of embedded inputs x (B, S, D) at positions 0 … S − 1."""
        B, S = x.shape[:2]
        M = max_len or S
        if M < S:
            raise ValueError(f"max_len={M} cannot hold a prompt of {S} tokens")
        cache = self.init_cache(B, M)
        x = constrain(x, ("batch", None, None))
        positions = self._positions(B, S)
        for i, block in enumerate(self.layers):
            x, k, v = block(x, positions)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        cache["length"] = S
        return self._head(x[:, -1:])[:, 0], cache

    def decode_step(self, cache: dict, tokens: Tensor):
        """One token per row, tokens (B, 1) → (logits (B, vocab), cache).

        Writes the new K/V into ``cache``'s tensors in place at position
        ``cache["length"]`` and returns the cache with the length advanced;
        raises a ``ValueError`` when that position lies past the cache."""
        pos = cache["length"]
        M = cache["k"].shape[2]
        if pos >= M:
            raise ValueError(
                f"KV cache full: decode position {pos} needs max_len > {pos}, the cache has {M}"
            )
        B = tokens.shape[0]
        x = constrain(self._embed(tokens), ("batch", None, None))
        positions = self._positions(B, 1, pos)
        kv_len = torch.full((B,), pos + 1, device=x.device)
        for i, block in enumerate(self.layers):
            q, k, v = block.qkv(x, positions)
            cache["k"][i, :, pos] = k[:, 0]
            cache["v"][i, :, pos] = v[:, 0]
            attn = common.decode_attention(q, cache["k"][i], cache["v"][i], kv_len)
            x = block.finish(x, attn)
        return self._head(x)[:, 0], {**cache, "length": pos + 1}


def loss_fn(cfg: TransformerConfig, model: nn.Module, batch: dict) -> Tensor:
    """The mean next-token cross-entropy of ``model``'s logits on
    ``batch["tokens"]`` against ``batch["labels"]`` (positions outside
    ``batch["mask"]``, where given, excluded)."""
    logits = model(batch["tokens"])
    return common.softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))


def fill_params(model: Transformer, cfg: TransformerConfig, g: torch.Generator) -> None:
    """Draw ``model``'s embedding, final norm, head and each block's
    ``shapes(cfg)`` parameters from ``g`` with the reference's init
    distributions (truncated normal, std 1/sqrt(fan_in), embedding std
    0.02; ones for norms, zeros for biases)."""
    pd = cfg.param_dtype

    def put(p: nn.Parameter, value: Tensor) -> None:
        p.copy_(value.to(device=p.device, dtype=p.dtype))

    put(model.embed, common.dense_init(g, (cfg.vocab, cfg.d_model), pd, 0.02))
    put(model.final_norm, common.ones_init((cfg.d_model,), pd))
    if not cfg.tie_embeddings:
        put(model.lm_head, common.dense_init(g, (cfg.d_model, cfg.vocab), pd))
    for blk in model.layers:
        for name, shape in blk.shapes(cfg).items():
            if name.startswith("ln"):
                value = common.ones_init(shape, pd)
            elif name in ("bq", "bk", "bv"):
                value = common.zeros_init(shape, pd)
            else:
                value = common.dense_init(g, shape, pd)
            put(getattr(blk, name), value)


@torch.no_grad()
def init_params(
    cfg: TransformerConfig, generator: torch.Generator | None = None, device=None
) -> Transformer:
    """A randomly initialised :class:`Transformer` on ``device`` (None =
    the card), drawn by :func:`fill_params` from ``generator`` (default:
    seed 0 on the target device)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device).manual_seed(0)
    model = Transformer(cfg, device)
    fill_params(model, cfg, g)
    return model
