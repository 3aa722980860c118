"""Model registry of the port (port of ``repro.models.model_api``).

``get_model(cfg)`` returns the model module of a config's family, whose
``init_params(cfg, generator, device)`` builds the ``nn.Module`` that
serves it (``forward``, ``prefill``, ``decode_step``, ``init_cache``).
Families not ported yet raise a ``TypeError`` that names them.
"""

from __future__ import annotations

from types import ModuleType

from repro_torch.models import mamba2, transformer, zamba

# most-derived first: ZambaConfig subclasses Mamba2Config, which
# subclasses TransformerConfig
_DISPATCH: list[tuple[type, ModuleType]] = [
    (zamba.ZambaConfig, zamba),
    (mamba2.Mamba2Config, mamba2),
    (transformer.TransformerConfig, transformer),
]


def get_model(cfg) -> ModuleType:
    for cls, mod in _DISPATCH:
        if isinstance(cfg, cls):
            return mod
    family = getattr(cfg, "family", None)
    raise TypeError(
        f"model family {family!r} ({type(cfg).__name__}) is not ported to "
        "repro_torch yet; ported: 'hybrid' (ZambaConfig), 'ssm' (Mamba2Config), "
        "'dense' (TransformerConfig)"
    )
