"""Hopper CUDA kernel of the Mamba-2 SSD scan (B5) and its ctypes wrapper.

The source is ``csrc/ssd.cu`` (a plain C entry point; the note at its
top says what it replaces, what bounds it on the card and how its design
answers that).  One call runs three launches — chunk states, state
passing, chunk scan — through a workspace the wrapper allocates
(:func:`ssd_workspace_floats`); :func:`repro_torch.kernels.ssd.ref.
ssd_three_pass_ref` models the three passes in plain torch.
:mod:`repro_torch.kernels._build` compiles it with ``nvcc`` for
``sm_90a`` on first use and loads it with ``ctypes``; :func:`build`
does it eagerly and reports the compile.

:func:`ssd_chunked_cuda` takes CUDA tensors only, checks device, dtype,
shape and contiguity, allocates its outputs with ``torch.empty``,
launches on ``torch.cuda.current_stream()``, raises if the launch
reported an error, and adds one to its ``launches`` counter (one per
call, whatever the launches behind it).  Its plain
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
# published chunk 128, head dim 64 and state 128, zamba2-2.7b's state 64,
# and the smoke configs' 16s
SHAPES = {(128, 64, 128), (128, 64, 64), (16, 16, 16)}

_LIB = CudaLibrary(
    "ssd",
    Path(__file__).resolve().parent / "csrc",
    {"ssd_chunked": [VP] * 8 + [I32] * 8 + [VP]},
)
build = _LIB.build


def ssd_workspace_floats(Bb: int, H: int, nc: int, chunk: int, P: int, N: int) -> int:
    """Float32 workspace of one call: every (b, h, chunk)'s P×N state
    (its local state ΔS after pass 1, the state entering it after pass 2),
    then every (b, h, chunk)'s ``chunk`` values of seg."""
    return Bb * H * nc * (P * N + chunk)


SCAN_MIN_BLOCKS_PER_SM = 1.5  # chunk-scan blocks per SM that head batching keeps


def scan_heads_per_block(Bb: int, nc: int, H: int, G: int, sms: int) -> int:
    """Heads of one B/C group that one chunk-scan block (pass 3) walks:
    the largest power of two dividing H / G that leaves at least
    ``SCAN_MIN_BLOCKS_PER_SM`` blocks per SM.  The group's C and B are
    staged, and its raw scores C·Bᵀ formed, once for those heads, and
    each head's loads hide behind the previous head's products; batching
    stops where the card would run short of blocks."""
    hb = 1
    while (H // G) % (2 * hb) == 0 and Bb * nc * H // (2 * hb) >= SCAN_MIN_BLOCKS_PER_SM * sms:
        hb *= 2
    return hb


def _aligned(t: Tensor) -> Tensor:
    """``t`` itself, or a fresh copy when a view leaves it off the 16-byte
    boundary the kernel's vector copies need."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    if not 0 < Bb * H * (L // chunk) < 2**31:
        raise ValueError(f"Bb·H·chunks = {Bb * H * (L // chunk)} outside the kernel's grid")
    nc = L // chunk
    x, B, C = _aligned(x), _aligned(B), _aligned(C)
    y = torch.empty_like(x)
    s = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ws = torch.empty(ssd_workspace_floats(Bb, H, nc, chunk, P, N), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rc = _LIB.lib().ssd_chunked(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), s.data_ptr(), ws.data_ptr(), Bb, nc, H, G, chunk, P, N,
        scan_heads_per_block(Bb, nc, H, G, sms), _build.stream(),
    )
    _build.check(rc, "ssd_chunked")
    _build.count(ssd_chunked_cuda)
    return y, s


ssd_chunked_cuda.launches = 0
