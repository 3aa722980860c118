"""Configs of the port (reference: ``repro.configs``).

Each module defines ``config()`` (the exact published configuration)
and ``smoke_config()`` (a reduced same-family config for CPU tests).
``get_config(name)`` / ``get_smoke_config(name)`` dispatch by id for
the configs ported so far and raise a ``ValueError`` for any other.
"""

from __future__ import annotations

import dataclasses
import importlib

PORTED = (
    "arctic_480b", "deepseek_v2_lite_16b", "granite_8b", "internvl2_2b", "llama3_405b",
    "mamba2_370m", "nemotron_4_15b", "qwen2_1_5b", "sthc_kth", "whisper_tiny", "zamba2_2_7b",
)


def _normalize(name: str) -> str:
    return name.replace("-", "_").replace(".", "_").replace("(", "").replace(")", "")


def get_module(name: str):
    key = _normalize(name)
    if key not in PORTED:
        raise ValueError(
            f"config {name!r} is unknown or not ported to repro_torch yet; "
            f"ported: {', '.join(PORTED)}"
        )
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str, **overrides):
    cfg = get_module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides):
    cfg = get_module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def arch_names() -> list[str]:
    """The LM architectures' canonical ids (the reference's ten)."""
    return [
        "granite-8b",
        "qwen2-1.5b",
        "llama3-405b",
        "nemotron-4-15b",
        "mamba2-370m",
        "zamba2-2.7b",
        "arctic-480b",
        "deepseek-v2-lite-16b",
        "whisper-tiny",
        "internvl2-2b",
    ]
