"""Mamba-2 (SSD — state-space duality) language model (port of
``repro.models.mamba2``).

Block (as the reference):

  in_proj → [z | x | B | C | dt]           (one fused matmul)
  causal conv1d (width d_conv) over [x|B|C], SiLU
  dt = softplus(dt + dt_bias);  A = −exp(A_log)
  y  = SSD(x·dt, exp(dt·A), B, C) + D ⊙ x  (chunked scan — kernels/ssd)
  y  = RMSNorm(y ⊙ silu(z))                (gated norm)
  out_proj

:class:`Mamba2` is an ``nn.Module`` holding its config, the embedding,
the final norm and an ``nn.ModuleList`` of :class:`Mamba2Block` (the
reference scans stacked layers instead).  Parameters are made without
``requires_grad`` (a trainer turns it on); :func:`loss_fn` is the
cross-entropy of ``forward``'s logits, each block rematerialised by
``cfg.remat_policy``.  Decode carries (conv_state (n_layers, B, d_conv−1,
conv_dim), ssm_state (n_layers, B, H, P, N)) — O(1) memory and FLOPs per
token.

``ssd_impl`` picks the SSD route.  ``'kernel'`` (the default) goes
through :func:`repro_torch.kernels.ssd.ops.ssd`: the hand-written CUDA
kernel for CUDA tensors, its plain version for CPU tensors — the
reference's ``'pallas'``.  ``'chunked'`` runs the plain chunked form on
either device — the reference's ``'jnp'``.  Both carry gradients: the
kernel route's backward recomputes the plain version under autograd.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import common, transformer

Tensor = torch.Tensor

# per-layer parameters, in the reference's names
LAYER_FIELDS = (
    "ln", "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w", "out_proj",
)


@dataclasses.dataclass(frozen=True)
class Mamba2Config(transformer.TransformerConfig):
    family: str = "ssm"
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128
    ssd_impl: str = "kernel"  # 'kernel' (ops.ssd) | 'chunked' (plain)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_proj_dim(self) -> int:
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.ssm_heads

    def num_params(self) -> int:
        D = self.d_model
        per_layer = (
            D * self.in_proj_dim
            + self.conv_dim * self.d_conv
            + self.conv_dim
            + 3 * self.ssm_heads  # A_log, D, dt_bias
            + self.d_inner  # gated-norm scale
            + self.d_inner * D
            + D  # ln
        )
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + D


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv1d.  xbc: (B, S, Cd); w: (Cd, K) → (B, S, Cd).
    The same unrolled shifts as the reference, so the rounding matches."""
    K = w.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    y = torch.zeros_like(xbc)
    for i in range(K):
        y = y + pad[:, i : i + xbc.shape[1], :] * w[None, None, :, i]
    return y + b[None, None, :]


def _split_proj(cfg: Mamba2Config, zxbcdt: Tensor):
    d_in = cfg.d_inner
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : d_in + cfg.conv_dim]
    dt = zxbcdt[..., d_in + cfg.conv_dim :]
    return z, xbc, dt


class Mamba2Block(nn.Module):
    """One residual Mamba-2 block (the reference's ``mamba2_block``,
    ``_block_decode`` and the body of ``prefill``)."""

    def __init__(self, cfg: Mamba2Config, device):
        super().__init__()
        self.cfg = cfg
        D, pd, f32 = cfg.d_model, cfg.param_dtype, torch.float32
        H = cfg.ssm_heads
        self.ln = _param((D,), pd, device)
        self.in_proj = _param((D, cfg.in_proj_dim), pd, device)
        self.conv_w = _param((cfg.conv_dim, cfg.d_conv), pd, device)
        self.conv_b = _param((cfg.conv_dim,), pd, device)
        self.A_log = _param((H,), f32, device)
        self.D = _param((H,), f32, device)
        self.dt_bias = _param((H,), f32, device)
        self.norm_w = _param((cfg.d_inner,), pd, device)
        self.out_proj = _param((cfg.d_inner, D), pd, device)

    def _ssd_operands(self, xbc: Tensor, dt: Tensor):
        """Post-conv activations and raw dt → the SSD's float32 operands
        (x (…, H, P), dt (…, H), A (H,), B and C (…, G, N))."""
        cfg = self.cfg
        g, N = cfg.n_groups, cfg.d_state
        lead = xbc.shape[:-1]
        xs = xbc[..., : cfg.d_inner].reshape(lead + (cfg.ssm_heads, cfg.ssm_head_dim))
        Bm = xbc[..., cfg.d_inner : cfg.d_inner + g * N].reshape(lead + (g, N))
        Cm = xbc[..., cfg.d_inner + g * N :].reshape(lead + (g, N))
        dt = F.softplus(dt.float() + self.dt_bias)
        A = -torch.exp(self.A_log)
        return xs.float(), dt, A, Bm.float(), Cm.float()

    def _mix(self, x: Tensor):
        """rms_norm → in_proj → (z, xbc before the conv, raw dt)."""
        cfg = self.cfg
        h = common.rms_norm(x, self.ln, cfg.norm_eps)
        return _split_proj(cfg, h @ self.in_proj.to(cfg.compute_dtype))

    def ssd_inputs(self, x: Tensor):
        """The operands this block hands the SSD for a full sequence x
        (B, S, D): float32 (x, dt, A, B, C) as ``ssd_ops.ssd`` takes them."""
        return self._full(x)[2]

    def _full(self, x: Tensor):
        cd = self.cfg.compute_dtype
        z, xbc_pre, dt = self._mix(x)
        xbc = F.silu(_causal_conv(xbc_pre, self.conv_w.to(cd), self.conv_b.to(cd)))
        return z, xbc_pre, self._ssd_operands(xbc, dt)

    def _out(self, x: Tensor, z: Tensor, y: Tensor, xh: Tensor) -> Tensor:
        """D skip, gate, gated norm, out_proj, residual."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        y = y + self.D[:, None] * xh
        y = y.reshape(x.shape[:-1] + (cfg.d_inner,)).to(cd)
        y = y * F.silu(z.float()).to(cd)
        y = common.rms_norm(y, self.norm_w, cfg.norm_eps)
        return x + y @ self.out_proj.to(cd)

    def forward(self, x: Tensor) -> tuple[Tensor, tuple[Tensor, Tensor]]:
        """Full-sequence block (B, S, D) → (x', (conv_state, ssm_state))."""
        cfg = self.cfg
        z, xbc_pre, (xh, dt, A, Bm, Cm) = self._full(x)
        conv_st = xbc_pre[:, x.shape[1] - (cfg.d_conv - 1) :]  # (B, K-1, Cd)
        y, ssm_st = ssd_ops.ssd(xh, dt, A, Bm, Cm, chunk=cfg.chunk, impl=cfg.ssd_impl)
        return self._out(x, z, y, xh), (conv_st, ssm_st)

    def decode(self, x: Tensor, conv_st: Tensor, ssm_st: Tensor):
        """Single-token block step.  x: (B, 1, D) → (x', conv', ssm')."""
        cd = self.cfg.compute_dtype
        z, xbc, dt = self._mix(x)
        # conv state: window of the last d_conv-1 inputs
        window = torch.cat([conv_st, xbc], dim=1)  # (B, K, Cd)
        conv_out = torch.einsum("bkc,ck->bc", window, self.conv_w.to(cd))
        xbc_t = F.silu(conv_out + self.conv_b.to(cd)[None, :])
        xh, dt_t, A, Bm, Cm = self._ssd_operands(xbc_t, dt[:, 0])
        new_ssm, y = ssd_ops.ssd_decode_step(ssm_st, xh, dt_t, A, Bm, Cm)
        return self._out(x, z, y[:, None], xh[:, None]), window[:, 1:], new_ssm


class Mamba2(nn.Module):
    """The Mamba-2 LM.  ``forward`` gives every position's logits;
    ``prefill`` the last position's logits and a decode-ready cache;
    ``decode_step`` one token.  Weights come from :func:`init_params` or
    ``repro_torch.interop.mamba2_params_from_numpy``."""

    def __init__(self, cfg: Mamba2Config, device):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), pd, device)
        self.final_norm = _param((cfg.d_model,), pd, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), pd, device)
        self.layers = nn.ModuleList(Mamba2Block(cfg, device) for _ in range(cfg.n_layers))

    def _head(self, x: Tensor) -> Tensor:
        cfg = self.cfg
        x = common.rms_norm(x, self.final_norm, cfg.norm_eps)
        cd = cfg.compute_dtype
        head = self.embed.to(cd).T if cfg.tie_embeddings else self.lm_head.to(cd)
        return x @ head

    def forward(self, tokens: Tensor) -> Tensor:
        """tokens (B, S) → logits (B, S, vocab)."""
        x = self.embed.to(self.cfg.compute_dtype)[tokens]

        def layer(x, block):
            return block(x)[0]

        layer = common.remat(self.cfg, layer)
        for block in self.layers:
            x = layer(x, block)
        return self._head(x)

    def init_cache(self, batch: int, max_len: int | None = None) -> dict:
        """Zero state cache (independent of max_len — SSM decode is O(1))."""
        cfg = self.cfg
        dev = self.embed.device
        return {
            "conv": torch.zeros(
                (cfg.n_layers, batch, cfg.d_conv - 1, cfg.conv_dim),
                dtype=cfg.compute_dtype, device=dev,
            ),
            "ssm": torch.zeros(
                (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_state),
                dtype=torch.float32, device=dev,
            ),
            "length": 0,
        }

    def prefill(self, tokens: Tensor, max_len: int | None = None):
        """Run the full prompt (B, S): last logits (B, vocab) + the cache.
        ``max_len`` is ignored: the SSM state does not grow."""
        x = self.embed.to(self.cfg.compute_dtype)[tokens]
        convs, ssms = [], []
        for block in self.layers:
            x, (conv_st, ssm_st) = block(x)
            convs.append(conv_st)
            ssms.append(ssm_st)
        logits = self._head(x[:, -1:])[:, 0]
        cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms), "length": tokens.shape[1]}
        return logits, cache

    def decode_step(self, cache: dict, tokens: Tensor):
        """One token per row, tokens (B, 1) → (logits (B, vocab), new cache).
        The given cache is not modified."""
        x = self.embed.to(self.cfg.compute_dtype)[tokens]
        convs, ssms = [], []
        for i, block in enumerate(self.layers):
            x, conv_st, ssm_st = block.decode(x, cache["conv"][i], cache["ssm"][i])
            convs.append(conv_st)
            ssms.append(ssm_st)
        logits = self._head(x)[:, 0]
        return logits, {
            "conv": torch.stack(convs), "ssm": torch.stack(ssms), "length": cache["length"] + 1,
        }


loss_fn = transformer.loss_fn  # the cross-entropy of forward's logits


@torch.no_grad()
def init_params(
    cfg: Mamba2Config, generator: torch.Generator | None = None, device=None
) -> Mamba2:
    """A randomly initialised :class:`Mamba2` on ``device`` (None = the
    card), with the reference's init distributions drawn from
    ``generator`` (default: seed 0 on the target device)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device).manual_seed(0)
    model = Mamba2(cfg, device)
    fill_params(model, cfg, g)
    return model


@torch.no_grad()
def fill_params(model: nn.Module, cfg: Mamba2Config, g: torch.Generator) -> None:
    """Draw the reference's init distributions from ``g`` into ``model``'s
    ``embed``, ``final_norm``, ``lm_head`` (untied only) and its
    :class:`Mamba2Block` ``layers`` (Zamba-2 fills its backbone with it)."""
    pd, H = cfg.param_dtype, cfg.ssm_heads

    def put(p: nn.Parameter, value: Tensor) -> None:
        p.copy_(value.to(device=p.device, dtype=p.dtype))

    def uniform(n: int, lo: float, hi: float) -> Tensor:
        return lo + (hi - lo) * torch.rand((n,), generator=g, device=g.device)

    put(model.embed, common.dense_init(g, (cfg.vocab, cfg.d_model), pd, 0.02))
    model.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        put(model.lm_head, common.dense_init(g, (cfg.d_model, cfg.vocab), pd))
    for blk in model.layers:
        put(blk.in_proj, common.dense_init(g, (cfg.d_model, cfg.in_proj_dim), pd))
        put(blk.out_proj, common.dense_init(g, (cfg.d_inner, cfg.d_model), pd))
        # dt_bias = softplus⁻¹ of dt log-uniform in [1e-3, 1e-1]
        dt0 = torch.exp(uniform(H, math.log(1e-3), math.log(0.1)))
        put(blk.dt_bias, dt0 + torch.log(-torch.expm1(-dt0)))
        put(blk.A_log, torch.log(uniform(H, 1.0, 16.0)))
        w = torch.randn((cfg.conv_dim, cfg.d_conv), generator=g, device=g.device)
        put(blk.conv_w, w / math.sqrt(cfg.d_conv))
        blk.conv_b.zero_()
        blk.ln.fill_(1.0)
        blk.D.fill_(1.0)
        blk.norm_w.fill_(1.0)
