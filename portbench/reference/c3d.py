"""Plain reference of C3D (Tran et al., ICCV 2015, arXiv:1412.0767,
section 3.3 and Fig. 3), the benchmark's own copy: the layers of the
released Caffe model (C3D v1.0, Sports-1M) in plain torch, independent
of the program under test.  It loads nothing of the program.

Each convolution is ``F.conv3d`` over (B, C, T, H, W) with 3x3x3 taps,
stride 1, padding 1, then ReLU; after each stage ``F.max_pool3d`` with
its window as stride and ``ceil_mode=True`` (Caffe's rounding up: pool5
takes 7x7x2 to 4x4x1); the flattened (C, T, H, W) features through
fc6, ReLU, fc7, ReLU, fc8 (dropout is identity at inference; no mean
clip is subtracted).  Weights: each convolution's (O, C, kT, kH, kW) and
bias, each fully connected layer's (in, out), applied as ``y @ W``, and
bias.  Clips are (B, C, H, W, T).

``precision``: ``"float64"`` is the yardstick; ``"tf32"`` the control,
float32 with TF32 on for cuBLAS and cuDNN and every operand of a
convolution or a product rounded to TF32 first (on the card that is what
TF32 reads; on the CPU, where the flags do nothing, the rounding stands
in for them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32's 10 mantissa bits (half away from zero)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def logits(clips: torch.Tensor, w: dict[str, torch.Tensor], m: dict, precision: str) -> torch.Tensor:
    """Logits (B, num_classes) of clips (B, C, H, W, T) in ``precision``."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    control = precision == "tf32"
    dtype = torch.float32 if control else torch.float64
    rnd = _tf32 if control else (lambda t: t)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = control
    try:
        x = clips.to(dtype).permute(0, 1, 4, 2, 3)  # (B, C, T, H, W)
        c = m["in_channels"]
        for i, (widths, (ph, pw, pt)) in enumerate(zip(m["stages"], m["pools"])):
            for j, _ in enumerate(widths):
                name = f"conv{i + 1}{'ab'[j]}"
                k = rnd(w[f"{name}_w"].to(dtype))
                x = F.relu(F.conv3d(rnd(x), k, w[f"{name}_b"].to(dtype), padding=m["kernel"] // 2))
            x = F.max_pool3d(x, (pt, ph, pw), stride=(pt, ph, pw), ceil_mode=True)
        x = x.reshape(x.shape[0], -1)
        n_fc = len(m["fc"]) + 1
        for k in range(n_fc):
            x = rnd(x) @ rnd(w[f"fc{6 + k}_w"].to(dtype)) + w[f"fc{6 + k}_b"].to(dtype)
            if k + 1 < n_fc:
                x = F.relu(x)
        return x
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
