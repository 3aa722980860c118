"""PyTorch/CUDA port of the STHC serving slice (reference: ``repro``).

The package mirrors the JAX reference's layout (``core/``,
``kernels/stmul/``, ``launch/``, ``configs/``) so every counterpart is
found by path and name.  It imports ``torch`` and numpy only.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``;
:func:`resolve_device` is the one place that decision is made.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> str:
    """The device an entry point runs on.

    ``None`` means the card: it resolves to ``"cuda"`` and raises when
    no GPU is present — a port entry point never drops to the CPU on
    its own.  Pass ``"cpu"`` explicitly to run the plain torch paths.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain torch path on the host"
            )
        return "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is unavailable")
    return str(dev)
