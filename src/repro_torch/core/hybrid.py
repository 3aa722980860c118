"""Hybrid optoelectronic 3-D CNN configuration (port of the
``HybridConfig`` dataclass of ``repro.core.hybrid``; the network itself
is ported in a later slice).

Architecture of the paper's proof of concept: input clip (C=1, 60×80,
16 frames) → 3-D conv layer of 9 kernels of 30×40×8, valid (the STHC)
→ bias + ReLU → 3-D max-pool → FC → ReLU → FC → 4 classes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    height: int = 60
    width: int = 80
    frames: int = 16
    in_channels: int = 1
    num_kernels: int = 9  # the paper's 9 parallel optical channels
    k_h: int = 30
    k_w: int = 40
    k_t: int = 8
    pool_window: tuple[int, int, int] = (8, 8, 3)
    hidden: int = 128
    num_classes: int = 4
    dtype: Any = torch.float32

    @property
    def conv_out_shape(self) -> tuple[int, int, int]:
        return (
            self.height - self.k_h + 1,
            self.width - self.k_w + 1,
            self.frames - self.k_t + 1,
        )

    @property
    def pooled_features(self) -> int:
        oh, ow, ot = self.conv_out_shape
        ph, pw, pt = self.pool_window
        n = ((oh - ph) // ph + 1) * ((ow - pw) // pw + 1) * ((ot - pt) // pt + 1)
        return n * self.num_kernels
