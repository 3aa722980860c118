"""The plain reference of C3D (Tran et al., ICCV 2015, arXiv:1412.0767,
section 3.3 and Fig. 3): plain ``torch`` in float32 with TF32 off for
both cuBLAS and cuDNN, for the tests that hold :mod:`repro_torch.models.c3d`
to it.  It imports nothing of the port's kernels.

Layers as the released Caffe model (C3D v1.0, Sports-1M): each
convolution ``F.conv3d`` over (B, C, T, H, W) with 3x3x3 taps, stride
1 and padding 1, then ReLU; after each stage ``F.max_pool3d`` with its
window as stride and ``ceil_mode=True`` (Caffe rounds a pool's output
size up: pool5 takes 7x7x2 to 4x4x1); the flattened (C, T, H, W)
features through fc6, ReLU, fc7, ReLU, fc8.

Departures from the Caffe model: dropout after fc6 and fc7 is identity
(inference); the input is not mean-subtracted (the clips are drawn as
they are, and a mean clip is a constant shift the weights could take).

``params`` maps the names of :func:`repro_torch.models.c3d.param_shapes`
to tensors (a ``C3D`` module's ``state_dict()`` will do); ``cfg`` is a
``C3DConfig``; clips are (B, C, H, W, T), the port's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def forward(params, clips: torch.Tensor, cfg) -> torch.Tensor:
    """Logits (B, num_classes), float32."""
    cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = clips.float().permute(0, 1, 4, 2, 3)  # (B, C, T, H, W)
        names = iter(name for name, _, _ in cfg.convs())
        for widths, (ph, pw, pt) in zip(cfg.stages, cfg.pools):
            for _ in widths:
                name = next(names)
                x = F.relu(F.conv3d(x, params[f"{name}_w"], params[f"{name}_b"], padding=1))
            x = F.max_pool3d(x, (pt, ph, pw), stride=(pt, ph, pw), ceil_mode=True)
        x = x.reshape(x.shape[0], -1)
        fcs = cfg.fcs()
        for k, (name, _, _) in enumerate(fcs):
            x = x @ params[f"{name}_w"] + params[f"{name}_b"]
            if k + 1 < len(fcs):
                x = F.relu(x)
        return x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
