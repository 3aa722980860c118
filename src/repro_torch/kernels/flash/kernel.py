"""Hopper CUDA kernels of the flash-attention forward (B6) and their
ctypes wrapper.

Two sources build one library: ``csrc/flash_wgmma.cu``, the bfloat16
kernel on Hopper's warpgroup tensor-core instructions (``wgmma``, a
three-stage ``cp.async`` K/V ring), and ``csrc/flash.cu``, the float32
kernel on the FMA pipes and the C entry points (the note at the top of each says what it replaces,
what bounds it on the card and how its design answers that).
:data:`ROUTES` says which of the two serves each ``(dtype, head dim)``,
and :func:`smem_bytes` the dynamic shared memory that build asks for.
:mod:`repro_torch.kernels._build` compiles the library with ``nvcc`` for
``sm_90a`` on first use and loads it with ``ctypes``; :func:`build` does
it eagerly and reports the compile.

:func:`flash_fwd_cuda` takes CUDA tensors only, checks dtype, shape,
contiguity, alignment and device, allocates its output with
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

# which kernel serves each (dtype, head dim): "wgmma" is the tensor-core
# kernel of csrc/flash_wgmma.cu, "fma" the float32 kernel of csrc/flash.cu
ROUTES = {
    (dtype, d): "wgmma" if dtype == torch.bfloat16 else "fma" for dtype in DTYPES for d in HEAD_DIMS
}

# the two kernels' tiles, as their sources set them: 64 query rows per
# block and 64 keys per kv tile in both; the wgmma kernel keeps
# WGMMA_STAGES (K, V) tiles in its ring and aligns its tiles to 1024 bytes
BQ = BK = 64
WGMMA_STAGES = 3
SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory one H100 block may have (227 KB)


def smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory of the build serving ``(dtype, d)``, as its
    source computes it (``flash_smem_bytes`` on the card returns the same).

    wgmma: bf16 rows of ``d`` rounded up to 16, Q and the ring of (K, V)
    stages, and 1024 bytes to align them; fma: float32 Q and K rows
    padded by 4, P (64 × 68) over K's space, and V."""
    if ROUTES[(dtype, d)] == "wgmma":
        dp = -(-d // 16) * 16
        return 2 * dp * (BQ + 2 * WGMMA_STAGES * BK) + 1024
    ld = d + 4
    return 4 * (BQ * ld + max(BK * ld, BQ * (BK + 4)) + BK * d)


_LIB = CudaLibrary(
    "flash",
    Path(__file__).resolve().parent / "csrc",
    {"flash_fwd": [VP] * 4 + [I32] * 8 + [F32, VP], "flash_smem_bytes": [I32, I32]},
)
build = _LIB.build


def smem_bytes_built(dtype: torch.dtype, d: int) -> int:
    """``flash_smem_bytes`` of the built library (needs ``nvcc``)."""
    return _LIB.lib().flash_smem_bytes(DTYPES[dtype], d)


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    _build.reset(flash_fwd_cuda)


def flash_fwd_cuda(
    q: Tensor, k: Tensor, v: Tensor, causal: bool = True, softmax_scale: float | None = None
) -> Tensor:
    """B6: the flash-attention forward of :func:`ref.flash_ref`.

    q (B, Sq, H, D); k and v (B, Sk, G, D) with G | H; one dtype,
    float32 or bfloat16, contiguous CUDA tensors; D in ``HEAD_DIMS``.
    bfloat16 runs the tensor-core kernel, float32 the FMA kernel
    (:data:`ROUTES`).
    The scale (default 1/sqrt(D)) multiplies the float32 scores.
    Returns (B, Sq, H, D) in q's dtype."""
    if q.dtype not in DTYPES:
        raise ValueError(f"no kernel for dtype {q.dtype}; built for {sorted(map(str, DTYPES))}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must have 4 dims, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, G, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"{H} query heads do not split into {G} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"no kernel for head dim {D}; built for {HEAD_DIMS}")
    if not (0 < Sq < BQ * 2**16 and 0 < Sk < 2**31 and 0 < B < 2**16):
        raise ValueError(f"shape q {tuple(q.shape)}, k {tuple(k.shape)} outside the kernel's grid")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must lie on one device")
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
