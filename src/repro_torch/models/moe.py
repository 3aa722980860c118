"""Mixture-of-experts LM (arctic-480b), and the MoE layer that
:mod:`repro_torch.models.mla` reuses (port of ``repro.models.moe``).

Routing is the reference's grouped dense dispatch: tokens are routed
within groups of ``gs`` tokens (the largest divisor of B·S that is at
most ``router_group``), each expert takes at most C = max(int(
capacity_factor · gs · top_k / E), 1) tokens of a group, slot-major (a
token's j-th choice queues behind every token's choices < j), and a
token past its expert's capacity is dropped for that choice.  The
dispatch and combine tensors are dense (G, gs, E, C) and the experts
run as the reference's four einsums (cuBLAS on the card).  Routing is
float32 whatever the compute dtype, and the top k takes the lower
expert index first on a tie, as ``lax.top_k`` does (``torch.topk``
leaves the order of ties unspecified).

At decode gs = B, so C is 1 while capacity_factor · B · top_k < 2E,
and tokens whose choices collide are dropped: prefill then decode does
not reproduce ``forward`` unless capacity_factor is large.  That is the
reference's semantics, kept as it is.

Arctic's layer (:class:`MoEBlock`) is the dense transformer's
attention, then the MoE on ``ln3`` in parallel with the dense SwiGLU
residual on ``ln2`` when ``dense_residual`` is set.  :class:`MoE` is the
port's :class:`~repro_torch.models.transformer.Transformer` over such
layers, with the dense transformer's K/V cache and prefill and decode
(so decode writes in place and raises past ``max_len``); ``forward``
also returns the mean of the layers' load-balance aux.  Its prefill
attention takes ``cfg.attn_impl``'s route as the dense transformer's
does (kernel B6 on the card).  Parameters are made without
``requires_grad`` (a trainer turns it on); :func:`loss_fn` adds
``router_aux_coef`` × the mean aux to the cross-entropy, each layer
rematerialised by ``cfg.remat_policy``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models import common, transformer

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig(transformer.TransformerConfig):
    family: str = "moe"
    n_experts: int = 128
    top_k: int = 2
    moe_d_ff: int = 4864  # per-expert hidden
    capacity_factor: float = 1.25
    router_group: int = 1024  # tokens per routing group
    dense_residual: bool = False  # arctic: dense FFN ∥ MoE
    n_shared_experts: int = 0  # deepseek: always-on shared experts
    first_k_dense: int = 0  # deepseek: leading dense layers
    router_aux_coef: float = 0.01
    norm_topk: bool = False

    def _count(self, experts: int) -> int:
        """Parameters with ``experts`` routed experts a layer."""
        D, V = self.d_model, self.vocab
        H, G, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * H * hd + 2 * D * G * hd + H * hd * D
        per_layer = attn + experts * 3 * D * self.moe_d_ff + D * self.n_experts + 2 * D
        per_layer += 3 * D * self.moe_d_ff * self.n_shared_experts
        if self.dense_residual:
            per_layer += 3 * D * self.d_ff
        emb = V * D * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + D

    def num_params(self) -> int:
        return self._count(self.n_experts)

    def active_params(self) -> int:
        """Per-token active parameters (for MODEL_FLOPS = 6·N_active·D)."""
        return self._count(self.top_k)


# ---------------------------------------------------------------------------
# MoE layer
# ---------------------------------------------------------------------------


def moe_shapes(cfg: MoEConfig) -> dict[str, tuple[int, ...]]:
    """The shape of each MoE parameter (the reference's ``moe_init``)."""
    D, Fm, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    shapes = {"router": (D, E), "we_gate": (E, D, Fm), "we_up": (E, D, Fm), "we_down": (E, Fm, D)}
    if cfg.n_shared_experts:
        Fs = Fm * cfg.n_shared_experts
        shapes.update(ws_gate=(D, Fs), ws_up=(D, Fs), ws_down=(Fs, D))
    return shapes


class MoEParams(nn.Module):
    """The MoE parameters under the reference's names: ``router`` (D, E)
    in float32 whatever the param dtype, the experts ``we_gate`` and
    ``we_up`` (E, D, Fm) and ``we_down`` (E, Fm, D), and the shared
    experts ``ws_*`` only when the config has them."""

    def __init__(self, cfg: MoEConfig, device):
        super().__init__()
        for name, shape in moe_shapes(cfg).items():
            dtype = torch.float32 if name == "router" else cfg.param_dtype
            setattr(self, name, transformer._param(shape, dtype, device))


def fill_moe(mp: MoEParams, cfg: MoEConfig, g: torch.Generator) -> None:
    """Draw ``mp`` from ``g`` with the reference's distributions, its
    fan-in included: ``dense_init`` takes fan_in = shape[0], so the
    expert tensors (E, ·, ·) get std 1/sqrt(E).  Experts are drawn one at
    a time, so the float32 transients are one expert's, not the whole
    (E, D, Fm) tensor's."""
    E = cfg.n_experts
    for name, shape in moe_shapes(cfg).items():
        p = getattr(mp, name)
        if name.startswith("we_"):
            for e in range(E):
                p[e].copy_(common.dense_init(g, shape[1:], p.dtype, 1.0 / math.sqrt(E)).to(p.device))
        else:
            p.copy_(common.dense_init(g, shape, p.dtype).to(p.device))


def _top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``lax.top_k``: the k largest along the last axis, in descending
    order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_dispatch(cfg: MoEConfig, probs: Tensor) -> tuple[Tensor, Tensor]:
    """Dispatch and combine tensors with capacity dropping.

    probs: (G, gs, E) router probabilities.  Returns (dispatch (G, gs, E,
    C), combine (G, gs, E, C)) in probs' dtype: dispatch is 1 where a
    token takes a slot of an expert's buffer, combine its gate value
    there.  A token's j-th choice queues behind every choice < j of the
    group (the counts carry across slots); a position >= C is dropped.
    Each cell receives at most one nonzero value, so the result is the
    reference's bit for bit."""
    G, gs, E = probs.shape
    k = cfg.top_k
    C = max(int(cfg.capacity_factor * gs * k / E), 1)

    gate_vals, idx = _top_k(probs, k)  # (G, gs, k)
    if cfg.norm_topk:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    experts = torch.arange(E, device=probs.device)[:, None]
    counts = torch.zeros((G, E), dtype=torch.int32, device=probs.device)
    dispatch = torch.zeros((G, gs, E * C), dtype=probs.dtype, device=probs.device)
    combine = torch.zeros_like(dispatch)
    for j in range(k):
        e = idx[..., j]  # (G, gs)
        # one-hot with the group's tokens innermost, so the queue is an
        # innermost-dim scan
        onehot = (e[:, None, :] == experts).to(torch.int32)  # (G, E, gs)
        # the token's place in its expert's buffer: the tokens ahead of
        # it in this slot, behind the earlier slots' count
        ahead = (torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot).gather(1, e[:, None])[:, 0]
        pos = ahead + counts.gather(1, e)  # (G, gs)
        keep = pos < C
        # a dropped token adds zero to a clamped slot
        slot = (e * C + pos.clamp(max=C - 1))[..., None]
        dispatch.scatter_add_(-1, slot, keep[..., None].to(probs.dtype))
        combine.scatter_add_(-1, slot, (keep * gate_vals[..., j])[..., None])
        counts += (onehot * keep[:, None, :]).sum(-1, dtype=torch.int32)
    return dispatch.view(G, gs, E, C), combine.view(G, gs, E, C)


def group_size(T: int, router_group: int) -> int:
    """Tokens per routing group: the largest divisor of T ≤ router_group."""
    gs = min(router_group, T)
    while T % gs != 0:
        gs -= 1
    return gs


def moe_block(cfg: MoEConfig, mp: MoEParams, x: Tensor) -> tuple[Tensor, Tensor]:
    """x (B, S, D) → (y, aux): the routed experts (and the shared ones)
    on x, and the Switch load-balance aux E · Σ_e f_e · p_e."""
    B, S, D = x.shape
    cd = cfg.compute_dtype
    xg = x.reshape(-1, group_size(B * S, cfg.router_group), D)  # (G, gs, D)

    probs = torch.softmax(xg.float() @ mp.router, dim=-1)  # (G, gs, E) float32 routing
    dispatch, combine = _topk_dispatch(cfg, probs)
    dispatch = constrain(dispatch.to(cd), ("batch", None, "expert", None))

    frac_tokens = dispatch.sum(-1).float().mean(1)  # (G, E)
    frac_probs = probs.mean(1)
    aux = cfg.n_experts * (frac_tokens * frac_probs).sum(-1).mean()

    xe = constrain(torch.einsum("gsec,gsd->gecd", dispatch, xg.to(cd)), ("batch", "expert", None, None))
    hg = torch.einsum("gecd,edf->gecf", xe, mp.we_gate.to(cd))
    hu = torch.einsum("gecd,edf->gecf", xe, mp.we_up.to(cd))
    ye = torch.einsum("gecf,efd->gecd", common.swiglu(hg, hu), mp.we_down.to(cd))
    ye = constrain(ye, ("batch", "expert", None, None))
    y = torch.einsum("gsec,gecd->gsd", combine.to(cd), ye).reshape(B, S, D)

    if cfg.n_shared_experts:
        hs = common.swiglu(x @ mp.ws_gate.to(cd), x @ mp.ws_up.to(cd))
        y = y + hs @ mp.ws_down.to(cd)
    return y, aux


# ---------------------------------------------------------------------------
# Arctic-style model: attention + (dense FFN ∥ MoE) residual
# ---------------------------------------------------------------------------


def layer_shapes(cfg: MoEConfig) -> dict[str, tuple[int, ...]]:
    """The shape of each per-layer parameter outside the MoE: the dense
    transformer's SwiGLU layer (without its MLP unless
    ``dense_residual``) and ``ln3``."""
    shapes = transformer.layer_shapes(dataclasses.replace(cfg, mlp="swiglu"))
    if not cfg.dense_residual:
        for name in ("w_gate", "w_up", "w_down"):
            del shapes[name]
    shapes["ln3"] = (cfg.d_model,)
    return shapes


class MoEBlock(transformer.TransformerBlock):
    """One Arctic layer (the reference's ``_layer_train``): attention and
    its residual, then the MoE on ``ln3`` beside the dense residual MLP."""

    shapes = staticmethod(layer_shapes)

    def __init__(self, cfg: MoEConfig, device):
        super().__init__(cfg, device)
        self.moe = MoEParams(cfg, device)

    def ffn(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """x (after attention) → (x + MLP (with ``dense_residual``) + MoE, aux)."""
        cfg = self.cfg
        y, aux = moe_block(cfg, self.moe, common.rms_norm(x, self.ln3, cfg.norm_eps))
        return (self.mlp(x) if cfg.dense_residual else x) + y, aux

    def finish(self, x: Tensor, attn: Tensor) -> Tensor:
        """The layer after attention, its aux dropped (prefill, decode)."""
        return self.ffn(self.attn_out(x, attn))[0]


class MoE(transformer.Transformer):
    """The Arctic-style LM.  ``forward`` gives every position's logits and
    the mean aux; ``prefill`` and ``decode_step`` are the dense
    transformer's over :class:`MoEBlock` layers.  Weights come from
    :func:`init_params` or ``repro_torch.interop.moe_params_from_numpy``."""

    block = MoEBlock

    def forward(self, tokens: Tensor) -> tuple[Tensor, Tensor]:
        """tokens (B, S) → (logits (B, S, vocab), mean aux)."""
        x = constrain(self._embed(tokens), ("batch", None, None))
        positions = self._positions(*tokens.shape)

        def layer(x, block):
            q, k, v = block.qkv(x, positions)
            x, aux = block.ffn(block.attn_out(x, transformer.causal_attention(self.cfg, q, k, v)))
            return constrain(x, ("batch", None, None)), aux

        layer = common.remat(self.cfg, layer)
        auxs = []
        for block in self.layers:
            x, aux = layer(x, block)
            auxs.append(aux)
        return constrain(self._head(x), ("batch", None, "vocab")), torch.stack(auxs).mean()


# each MoE parameter's logical axes, as the reference's ``moe_init`` gives
# them; the decode cache is the dense transformer's
MOE_AXES = {
    "router": ("embed", "expert"),
    "we_gate": ("expert", "embed", "expert_mlp"),
    "we_up": ("expert", "embed", "expert_mlp"),
    "we_down": ("expert", "expert_mlp", "embed"),
    "ws_gate": ("embed", "mlp"), "ws_up": ("embed", "mlp"), "ws_down": ("mlp", "embed"),
}
CACHE_AXES = transformer.CACHE_AXES


def moe_axes(cfg: MoEConfig) -> dict[str, tuple]:
    """The axes of the MoE parameters ``cfg`` has."""
    return {n: MOE_AXES[n] for n in moe_shapes(cfg)}


def logical_axes(cfg: MoEConfig) -> dict:
    """Every parameter's logical axes in the reference's tree, as
    :func:`repro_torch.models.transformer.logical_axes`, each layer's MoE
    under ``moe``."""
    per_layer = {**transformer.LAYER_AXES, "ln3": (None,)}
    layer = {n: per_layer[n] for n in layer_shapes(cfg)}
    return {**transformer.outer_axes(cfg),
            "layers": common.stacked_axes({**layer, "moe": moe_axes(cfg)})}


def loss_fn(cfg: MoEConfig, model: nn.Module, batch: dict) -> Tensor:
    """Cross-entropy of the logits plus ``router_aux_coef`` × the aux."""
    logits, aux = model(batch["tokens"])
    ce = common.softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + cfg.router_aux_coef * aux


@torch.no_grad()
def init_params(cfg: MoEConfig, generator: torch.Generator | None = None, device=None) -> MoE:
    """A randomly initialised :class:`MoE` on ``device`` (None = the
    card): the dense transformer's draws (:func:`transformer.fill_params`;
    ones for ``ln3``) and each layer's MoE by :func:`fill_moe`, from
    ``generator`` (default: seed 0 on the target device)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device).manual_seed(0)
    model = MoE(cfg, device)
    transformer.fill_params(model, cfg, g)
    for blk in model.layers:
        fill_moe(blk.moe, cfg, g)
    return model
