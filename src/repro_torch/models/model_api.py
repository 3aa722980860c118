"""Model registry of the port (port of ``repro.models.model_api``).

``get_model(cfg)`` returns the model module of a config's family, whose
``init_params(cfg, generator, device)`` builds the ``nn.Module`` that
serves it (``forward``, ``prefill``, ``decode_step``, ``init_cache``).
A config of no registered family raises a ``TypeError``.
"""

from __future__ import annotations

from types import ModuleType

from repro_torch.models import mamba2, mla, moe, transformer, vlm, whisper, zamba

# most-derived first: MLAConfig subclasses MoEConfig, ZambaConfig
# subclasses Mamba2Config, and each of them (WhisperConfig and VLMConfig
# too) TransformerConfig
_DISPATCH: list[tuple[type, ModuleType]] = [
    (mla.MLAConfig, mla),
    (moe.MoEConfig, moe),
    (zamba.ZambaConfig, zamba),
    (mamba2.Mamba2Config, mamba2),
    (whisper.WhisperConfig, whisper),
    (vlm.VLMConfig, vlm),
    (transformer.TransformerConfig, transformer),
]


def get_model(cfg) -> ModuleType:
    for cls, mod in _DISPATCH:
        if isinstance(cfg, cls):
            return mod
    family = getattr(cfg, "family", None)
    raise TypeError(
        f"no model registered for family {family!r} ({type(cfg).__name__}); ported: "
        "'moe' (MLAConfig, MoEConfig), 'hybrid' (ZambaConfig), 'ssm' (Mamba2Config), "
        "'audio' (WhisperConfig), 'vlm' (VLMConfig), 'dense' (TransformerConfig)"
    )


def model_flops_per_token(cfg, train: bool = True) -> float:
    """MODEL_FLOPS/token: 6·N (train) or 2·N (inference forward), N the
    active parameters where the config counts them, else all."""
    n = cfg.active_params() if hasattr(cfg, "active_params") else cfg.num_params()
    return (6.0 if train else 2.0) * n
