"""Three-term roofline of a counted step on the H100 (the port's twin of
``repro.launch.roofline``).  All terms in seconds per step, per card:

  compute    = sum over FLOP classes of the class's FLOPs / the card's
               peak for that class (``PEAK_BY_CLASS``)
  memory     = HBM bytes / HBM bandwidth
  collective = collective wire bytes / NVLink bandwidth per direction

FLOPs, bytes and classes come from ``launch.op_analysis`` (an
``OpCounter`` around the step).  The constants are the H100 SXM 80 GB's
dense (no sparsity) peaks: HBM3 3.35e12 B/s, bf16 tensor cores 989e12
FLOP/s, TF32 tensor cores 495e12 (a 3xTF32 product runs three, so a
third of it), float32 outside the tensor cores 67e12 (a float32 GEMM
with TF32 off runs there too), NVLink 450e9 B/s per direction.

``parse_collectives`` has no twin: there is no HLO to parse, and on one
card the counter sees no collective, so ``collective_s`` is 0 and the
collective fields are empty.  The collective term comes with the mesh
dry run (ROADMAP A.8b).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.launch.op_analysis import BF16_TC, F32_CORE, F32_GEMM, TF32X3, Analysis, KernelCost

HBM_BW = 3.35e12  # B/s
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor cores
PEAK_FLOPS_TF32 = 495e12  # dense TF32 tensor cores
PEAK_FLOPS_F32 = 67e12  # float32 outside the tensor cores
NVLINK_BW = 450e9  # B/s per direction
DEVICE_MEMORY_BYTES = 80 * 10**9  # the card's rated HBM

PEAK_BY_CLASS = {
    BF16_TC: PEAK_FLOPS_BF16,
    F32_GEMM: PEAK_FLOPS_F32,
    TF32X3: PEAK_FLOPS_TF32 / 3,
    F32_CORE: PEAK_FLOPS_F32,
}


@dataclasses.dataclass
class Roofline:
    flops: float  # per device per step
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float  # 6·N·D (or 2·N·D serve) across the whole job
    useful_flops_ratio: float  # MODEL_FLOPS / (counted FLOPs × chips)
    collective_counts: dict[str, int]
    collective_bytes_by_kind: dict[str, int]
    flops_by_class: dict[str, float]

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def analyze(analysis: Analysis, n_chips: int, model_flops_total: float) -> Roofline:
    """The three-term roofline of a step counted by ``op_analysis``.
    ``model_flops_total``: the 6·N·D-style useful FLOPs of the whole job's
    step."""
    compute_s = sum(f / PEAK_BY_CLASS[cls] for cls, f in analysis.flops_by_class.items())
    memory_s = analysis.hbm_bytes / HBM_BW
    collective_s = analysis.total_collective_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    total = analysis.flops * n_chips
    return Roofline(
        flops=analysis.flops,
        hbm_bytes=analysis.hbm_bytes,
        collective_bytes=float(analysis.total_collective_bytes),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops_total,
        useful_flops_ratio=model_flops_total / total if total else 0.0,
        collective_counts={k: int(v) for k, v in analysis.collective_counts.items()},
        collective_bytes_by_kind={k: int(v) for k, v in analysis.collective_bytes.items()},
        flops_by_class=dict(analysis.flops_by_class),
    )


def kernel_bound_s(cost: KernelCost, peak: float | None = None) -> tuple[float, str]:
    """The least time the card could take for one kernel call: the larger
    of its bytes over HBM bandwidth and its FLOPs over ``peak`` (default:
    the peak of its class), with which of the two it is."""
    t_bytes = cost.bytes / HBM_BW
    t_ops = cost.flops / (peak or PEAK_BY_CLASS[cost.cls])
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
