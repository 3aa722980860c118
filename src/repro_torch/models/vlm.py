"""InternVL2-2B backbone (port of ``repro.models.vlm``): the dense
transformer (InternLM2-1.8B) run causally over vision-patch embeddings
prepended to the token embeddings.

The InternViT frontend is a stub, as in the reference: a batch carries
precomputed ``patches`` (B, Np, d_model) beside its ``tokens`` (B, S).
:class:`VLM` is the port's :class:`~repro_torch.models.transformer.Transformer`
with the same blocks, ``init_cache`` and ``decode_step``; only
``forward`` and ``prefill`` differ, running over ``[patches ; tokens]``
at positions 0 … Np + S − 1.  The cache's ``length`` is Np + S, so
decode's RoPE positions continue after the patches, and ``max_len``
counts the patches: a prefill raises when it is shorter than Np + S.
Prefill attention takes ``cfg.attn_impl`` as the dense family does (B6
at head dim 128 on the card).  :func:`loss_fn` takes the cross-entropy
over the text positions only (the patch prefix is masked out).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models import common, transformer

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class VLMConfig(transformer.TransformerConfig):
    family: str = "vlm"
    n_patches: int = 256  # one 448×448 tile → 256 visual tokens


class VLM(transformer.Transformer):
    """The VLM's language model over ``[patches ; tokens]``.  Weights come
    from :func:`init_params` or ``repro_torch.interop.vlm_params_from_numpy``."""

    def _inputs(self, batch: dict) -> Tensor:
        """``cat([patches, embed[tokens]])`` (B, Np + S, D) in the compute dtype."""
        cd = self.cfg.compute_dtype
        patches = batch["patches"].to(device=self.embed.device, dtype=cd)
        return torch.cat([patches, self._embed(batch["tokens"])], dim=1)

    def forward(self, batch: dict) -> Tensor:
        """batch {patches (B, Np, D), tokens (B, S)} → logits (B, Np + S, vocab)."""
        return self._forward_embedded(self._inputs(batch))

    def prefill(self, batch: dict, max_len: int | None = None):
        """The prompt's last logits (B, vocab) and a cache of ``max_len``
        (default Np + S) positions holding the K/V of patches and tokens."""
        total = batch["patches"].shape[1] + batch["tokens"].shape[1]
        M = max_len or total
        if M < total:
            raise ValueError(
                f"max_len={M} cannot hold {batch['patches'].shape[1]} patches and a prompt of "
                f"{batch['tokens'].shape[1]} tokens (max_len counts the patches)"
            )
        return self._prefill_embedded(self._inputs(batch), M)


def loss_fn(cfg: VLMConfig, model: transformer.Transformer, batch: dict) -> Tensor:
    """The cross-entropy of the logits at the text positions (after the
    ``n_patches`` prefix) against ``batch["labels"]`` (B, S)."""
    logits = model(batch)
    n_patches = batch["patches"].shape[1]
    return common.softmax_cross_entropy(logits[:, n_patches:], batch["labels"], batch.get("mask"))


@torch.no_grad()
def init_params(cfg: VLMConfig, generator: torch.Generator | None = None, device=None) -> VLM:
    """A randomly initialised :class:`VLM` on ``device`` (None = the card),
    drawn by the transformer's ``fill_params`` from ``generator`` (default:
    seed 0 on the target device)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device).manual_seed(0)
    model = VLM(cfg, device)
    transformer.fill_params(model, cfg, g)
    return model
