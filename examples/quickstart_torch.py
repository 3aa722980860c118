"""Quickstart on the PyTorch/CUDA port — the twin of ``examples/quickstart.py``.

1. build a correlator, record kernels into the atomic grating,
2. correlate a video clip — the ideal pipeline matches digital convolution,
3. the physical pipeline shows the (small) cost of real atoms + SLM —
   and any *subset* of its stages isolates one effect,
4. one hybrid-CNN training step.

On the card (the hand-written CUDA kernels) by default; ``--device cpu``
runs the plain torch versions on the host:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fidelity, hybrid, spectral_conv
from repro_torch.core.sthc import STHC, STHCConfig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    device = resolve_device(ap.parse_args().device)
    rng = np.random.RandomState(0)

    # a clip (batch 2, 1 channel, 36×48 px, 12 frames) and 4 learned kernels
    clip = torch.from_numpy(rng.rand(2, 1, 36, 48, 12).astype(np.float32)).to(device)
    kernels = torch.from_numpy(rng.randn(4, 1, 12, 16, 6).astype(np.float32)).to(device)

    # --- 1+2: ideal correlator ≡ digital 3-D convolution -----------------
    sthc = STHC(STHCConfig(fidelity=fidelity.ideal(), device=device))
    grating = sthc.record(kernels, tuple(clip.shape[-3:]))  # 'store' in the atoms
    feature_maps = sthc.correlate(grating, clip)  # 'diffract' the query
    ref = spectral_conv.direct_correlate3d(clip, kernels, "valid")
    print(f"feature maps {tuple(feature_maps.shape)}, "
          f"ideal-vs-digital max err {float(torch.max(torch.abs(feature_maps - ref))):.2e}")

    # --- 3: the physical pipeline (8-bit SLM, ± channels, IHB, T2, echo) --
    phys = STHC(STHCConfig(fidelity=fidelity.physical(), device=device))
    y_phys = phys(kernels, clip)
    rel = float(torch.linalg.norm(y_phys - ref) / torch.linalg.norm(ref))
    print(f"physical-pipeline relative error: {rel:.1%}  (the paper's "
          "accuracy drop comes from effects like these)")

    # ... and fidelity is composable: any stage subset isolates one effect.
    quant_only = STHC(STHCConfig(
        fidelity=fidelity.pipeline(fidelity.SLMQuantize(), name="slm-only"), device=device
    ))
    y_q = quant_only(kernels, clip)
    rel_q = float(torch.linalg.norm(y_q - ref) / torch.linalg.norm(ref))
    print(f"SLM-quantization-only relative error: {rel_q:.2%} "
          "(one stage of the stack above)")

    # --- 4: one hybrid-CNN training step ----------------------------------
    cfg = hybrid.HybridConfig(height=36, width=48, frames=12, k_h=12, k_w=16,
                              k_t=6, num_kernels=4, pool_window=(6, 8, 3),
                              hidden=32)
    params = hybrid.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    batch = {"video": clip, "label": torch.tensor([0, 1], device=device)}
    loss, _ = hybrid.loss_fn(params, batch, cfg, impl="spectral")
    print(f"hybrid CNN initial loss: {loss.item():.3f} (ln 4 = 1.386)")
    loss.backward()
    print("gradient flows through the optical layer:",
          bool(torch.any(params.conv_w.grad != 0)))


if __name__ == "__main__":
    main()
