"""AdamW over a dict of named tensors (port of ``repro.optim.adamw``).

The reference's arithmetic, kept as it is: the gradients are clipped by
their global norm with scale ``clip_norm / max(gnorm, 1e-12)`` when
``gnorm > clip_norm``, and the decoupled decay is added to the
bias-corrected step, ``delta = mhat / (sqrt(vhat) + eps) + wd * p``,
``p <- p - lr * delta``, all in float32 with m and v stored in
``state_dtype``.  ``torch.optim.AdamW`` with ``clip_grad_norm_`` is not
the same function: its clip coefficient is ``max_norm / (norm + 1e-6)``
and it decays the weight before the Adam step, so it is not used.

``params`` is a dict of named tensors, e.g. ``dict(model.named_parameters())``;
:func:`adamw_update` writes the new values into those tensors (and into
the state's) in place under ``torch.no_grad()`` and returns them.  The
step count is an int32 tensor on the parameters' device, so neither the
update nor a schedule evaluated on it waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32  # bf16 halves optimizer memory


def adamw_init(cfg: AdamWConfig, params: dict[str, Tensor]) -> dict:
    """Zero moments in ``state_dtype`` and a zero step count."""
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device) for k, p in params.items()}
    return {
        "m": zeros,
        "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: dict[str, Tensor]) -> Tensor:
    """sqrt of the sum of every leaf's float32 squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: dict[str, Tensor],
    grads: dict[str, Tensor],
    state: dict,
    lr_scale: Tensor | float = 1.0,
) -> tuple[dict[str, Tensor], dict, dict[str, Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics)."""
    state["step"] += 1
    step = state["step"].float()
    gnorm = global_norm(grads)
    scale = torch.where(
        gnorm > cfg.clip_norm, cfg.clip_norm / torch.clamp(gnorm, min=1e-12), 1.0
    )
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=step.device)
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, state, {"grad_norm": gnorm, "clip_scale": scale}
