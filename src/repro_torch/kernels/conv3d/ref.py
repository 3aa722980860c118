"""Plain torch version of the direct (valid) 3-D correlation (port of
``repro.kernels.conv3d.ref``).

The digital-baseline operator: what C3D-style networks compute and what
the paper's optical correlator replaces.  Cross-correlation (no kernel
flip), NCHWT layout.  One ``F.conv3d`` in full float32: cuDNN runs float32
convolutions in TF32 unless told otherwise, the reference at
``Precision.HIGHEST``.  bfloat16 inputs are summed in float32 and the
result rounded to their dtype, as the kernel does.  It is the kernel's
plain version on the CPU and its yardstick on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spectral_conv import full_precision


def conv3d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W, T), w: (O, C, kh, kw, kt) → (B, O, H', W', T')."""
    with full_precision():
        return F.conv3d(x.float(), w.float()).to(x.dtype)
