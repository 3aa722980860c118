"""Hopper CUDA kernel of the Mamba-2 SSD scan (B5) and its ctypes wrapper.

The source is ``csrc/ssd.cu`` (a plain C entry point; the note at its
top says what it replaces, what bounds it on the card and how its design
answers that).  :mod:`repro_torch.kernels._build` compiles it with
``nvcc`` for ``sm_90a`` on first use and loads it with ``ctypes``;
:func:`build` does it eagerly and reports the compile.

:func:`ssd_chunked_cuda` takes CUDA tensors only, checks device, dtype,
shape and contiguity, allocates its outputs with ``torch.empty``,
launches on ``torch.cuda.current_stream()``, raises if the launch
reported an error, and adds one to its ``launches`` counter.  Its plain
version is :func:`repro_torch.kernels.ssd.ref.ssd_chunked_ref`; the
routing between the two (by the tensor's device) is in
:mod:`repro_torch.kernels.ssd.ops`.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, VP, CudaLibrary

Tensor = torch.Tensor

# (chunk, head dim P, state N) the kernel is instantiated for: mamba2-370m's
# published chunk 128, head dim 64 and state 128, and its smoke config's 16s
SHAPES = {(128, 64, 128), (16, 16, 16)}

_LIB = CudaLibrary(
    "ssd",
    Path(__file__).resolve().parent / "csrc",
    {"ssd_chunked": [VP] * 7 + [I32] * 7 + [VP]},
)
build = _LIB.build


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    _build.reset(ssd_chunked_cuda)


def ssd_chunked_cuda(
    x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, chunk: int
) -> tuple[Tensor, Tensor]:
    """B5: the chunked SSD scan of :func:`ref.ssd_chunked_ref` from a zero
    state.  x (Bb, L, H, P), dt (Bb, L, H), A (H,), B and C (Bb, L, G, N),
    all float32 and contiguous, L a multiple of ``chunk``.  Returns
    y (Bb, L, H, P) float32 and the final state (Bb, H, P, N) float32."""
    _build.require(x, "x", torch.float32, 4)
    _build.require(dt, "dt", torch.float32, 3)
    _build.require(A, "A", torch.float32, 1)
    _build.require(B, "B", torch.float32, 4)
    _build.require(C, "C", torch.float32, 4)
    Bb, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    chunk = int(chunk)
    if dt.shape != (Bb, L, H) or A.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not match x {tuple(x.shape)}")
    if B.shape[:2] != (Bb, L) or C.shape != B.shape:
        raise ValueError(f"B {tuple(B.shape)} / C {tuple(C.shape)} do not match x {tuple(x.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("x, dt, A, B and C must lie on one device")
    if (chunk, P, N) not in SHAPES:
        raise ValueError(f"no kernel for chunk={chunk}, P={P}, N={N}; built for {sorted(SHAPES)}")
    if L % chunk:
        raise ValueError(f"L={L} not a multiple of chunk={chunk}")
    if not 0 < Bb * H < 2**31:
        raise ValueError(f"Bb·H = {Bb * H} outside the kernel's grid")
    y = torch.empty_like(x)
    s = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    rc = _LIB.lib().ssd_chunked(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), s.data_ptr(), Bb, L // chunk, H, G, chunk, P, N, _build.stream(),
    )
    _build.check(rc, "ssd_chunked")
    _build.count(ssd_chunked_cuda)
    return y, s


ssd_chunked_cuda.launches = 0
