"""Hopper CUDA kernel of the flash-attention forward (B6) and its ctypes
wrapper.

The source is ``csrc/flash.cu`` (a plain C entry point; the note at its
top says what it replaces, what bounds it on the card and how its design
answers that).  :mod:`repro_torch.kernels._build` compiles it with
``nvcc`` for ``sm_90a`` on first use and loads it with ``ctypes``;
:func:`build` does it eagerly and reports the compile.

:func:`flash_fwd_cuda` takes CUDA tensors only, checks device, dtype,
shape, contiguity and alignment, allocates its output with
``torch.empty``, launches on ``torch.cuda.current_stream()``, raises if
the launch reported an error, and adds one to its ``launches`` counter.
Its plain version is :func:`repro_torch.kernels.flash.ref.flash_ref`;
the routing between the two (by the tensor's device) is in
:mod:`repro_torch.kernels.flash.ops`.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, VP, CudaLibrary

Tensor = torch.Tensor

# head dims the kernel is instantiated for: 128 is every dense config's
# full width; 24, 32 and 16 are the qwen2, granite and llama3/nemotron
# smoke configs (and the reference test sweep's 16 and 32)
HEAD_DIMS = (16, 24, 32, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = CudaLibrary(
    "flash",
    Path(__file__).resolve().parent / "csrc",
    {"flash_fwd": [VP] * 4 + [I32] * 8 + [F32, VP]},
)
build = _LIB.build


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    _build.reset(flash_fwd_cuda)


def flash_fwd_cuda(
    q: Tensor, k: Tensor, v: Tensor, causal: bool = True, softmax_scale: float | None = None
) -> Tensor:
    """B6: the flash-attention forward of :func:`ref.flash_ref`.

    q (B, Sq, H, D); k and v (B, Sk, G, D) with G | H; one dtype,
    float32 or bfloat16, contiguous CUDA tensors; D in ``HEAD_DIMS``.
    The scale (default 1/sqrt(D)) multiplies the float32 scores.
    Returns (B, Sq, H, D) in q's dtype."""
    if q.dtype not in DTYPES:
        raise ValueError(f"no kernel for dtype {q.dtype}; built for {sorted(map(str, DTYPES))}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, name, q.dtype, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, G, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"{H} query heads do not split into {G} kv heads")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must lie on one device")
    if D not in HEAD_DIMS:
        raise ValueError(f"no kernel for head dim {D}; built for {HEAD_DIMS}")
    if not (0 < Sq < 64 * 2**16 and 0 < Sk < 2**31 and 0 < B < 2**16):
        raise ValueError(f"shape q {tuple(q.shape)}, k {tuple(k.shape)} outside the kernel's grid")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    rc = _LIB.lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, Sk, H, G, D, DTYPES[q.dtype], int(bool(causal)), float(scale), _build.stream(),
    )
    _build.check(rc, "flash_fwd")
    _build.count(flash_fwd_cuda)
    return o


flash_fwd_cuda.launches = 0
