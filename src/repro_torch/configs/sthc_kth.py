"""The paper's own workload: STHC on KTH-geometry clips (port of
``repro.configs.sthc_kth``).

60×80 px frames, 9 optical kernels of 30×40×8 with C = 1, 4 action
classes (§4.1); video search streams through 64-frame coherence windows
(``VideoSearchConfig.window_frames``).  ``smoke_config()`` shrinks
everything for CPU test loops; ``fidelity_stacks()`` names the
degradation-decomposition sweep.
"""

from repro_torch.core import fidelity
from repro_torch.core.hybrid import HybridConfig

# The paper geometry as plain values, for drivers that need no model.
FRAME_HW = (60, 80)
KERNEL_SHAPE = (9, 1, 30, 40, 8)  # (O, C, kh, kw, kt)
WINDOW_FRAMES = 64


def config() -> HybridConfig:
    return HybridConfig(
        height=60,
        width=80,
        frames=16,
        in_channels=1,
        num_kernels=9,
        k_h=30,
        k_w=40,
        k_t=8,
        pool_window=(8, 8, 3),
        hidden=128,
        num_classes=4,
    )


def fidelity_stacks() -> list[tuple[str, fidelity.FidelityPipeline]]:
    """The §4 decomposition sweep: cumulative paper stacks (digital →
    full physical) plus an uncompensated-pulse variant."""
    stacks = list(fidelity.ablation_stacks())
    stacks.append(("pulse_uncompensated", fidelity.physical(compensate_pulse=False)))
    return stacks


def smoke_config() -> HybridConfig:
    return HybridConfig(
        height=20,
        width=24,
        frames=10,
        in_channels=1,
        num_kernels=3,
        k_h=7,
        k_w=9,
        k_t=4,
        pool_window=(4, 4, 2),
        hidden=16,
        num_classes=4,
    )
