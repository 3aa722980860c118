"""Plain torch version of the direct (valid) 3-D correlation (port of
``repro.kernels.conv3d.ref``).

The digital-baseline operator: what C3D-style networks compute and what
the paper's optical correlator replaces.  Cross-correlation (no kernel
flip), NCHWT layout.  One ``F.conv3d`` in full float32: cuDNN runs float32
convolutions in TF32 unless told otherwise, the reference at
``Precision.HIGHEST``.  bfloat16 inputs are summed in float32 and the
result rounded to their dtype, as the kernel does.  It is the kernel's
plain version on the CPU and its yardstick on the card.

:func:`conv3d_3xtf32_ref` is a CPU model of the tensor-core kernel's
arithmetic (``csrc/conv3d_tc.cu``), for the tests only: the same
correlation from the 3xTF32 split of x and w.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spectral_conv import full_precision


def conv3d_ref(x: torch.Tensor, w: torch.Tensor, pad: int = 0, bias: torch.Tensor | None = None,
               relu: bool = False, channels_last: bool = False) -> torch.Tensor:
    """x: (B, C, H, W, T), w: (O, C, kh, kw, kt) → (B, O, H', W', T').

    With ``pad`` x is read with that many zero voxels on each side of H,
    W and T, ``bias`` (O,) is added and ``relu`` applied in float32;
    with ``channels_last`` x is (B, H, W, T, C) and the result (B, H',
    W', T', O), as the kernel's ``igemm`` route lays them out."""
    xv = x.permute(0, 4, 1, 2, 3) if channels_last else x
    with full_precision():
        y = F.conv3d(xv.float(), w.float(), padding=int(pad))
        if bias is not None:
            y = y + bias.float()[None, :, None, None, None]
        if relu:
            y = F.relu(y)
    y = y.to(x.dtype)
    return y.permute(0, 2, 3, 4, 1).contiguous() if channels_last else y


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 v = hi + lo as the kernel splits it: hi rounded to TF32 (10
    explicit mantissa bits, ties away from zero, as cvt.rna rounds), lo the
    rest as the tensor core reads it (its top 19 bits: truncated)."""
    bits = v.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((v.float() - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def conv3d_3xtf32_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The valid correlation of float32 x and w as the tensor-core kernel
    forms it: hi·hi + hi·lo + lo·hi of the TF32 split (lo·lo dropped), the
    products exact and summed in float64, rounded to float32 once."""
    xh, xl = (t.double() for t in tf32_split(x))
    wh, wl = (t.double() for t in tf32_split(w))
    y = F.conv3d(xh, wh + wl) + F.conv3d(xl, wh)
    return y.float()
