"""Hopper CUDA kernel of the direct valid 3-D correlation (B4) and its
ctypes wrapper.

The source is ``csrc/conv3d.cu`` (a plain C entry point; the note at its
top says what it replaces, what bounds it on the card and how its design
answers that).  :mod:`repro_torch.kernels._build` compiles it with
``nvcc`` for ``sm_90a`` on first use and loads it with ``ctypes``;
:func:`build` does it eagerly and reports the compile.

:func:`plan` chooses the instantiation and the block tile from the
shapes alone; it is plain Python, so the CPU tests check that its tiles
cover every output once and fit in shared memory.

:func:`conv3d_cuda` takes CUDA tensors only, checks device, dtype,
shape, contiguity and channel agreement, allocates its output with
``torch.empty``, launches on ``torch.cuda.current_stream()``, raises if
the launch reported an error, and adds one to its ``launches`` counter.
Its plain version is :func:`repro_torch.kernels.conv3d.ref.conv3d_ref`;
the routing between the two (by the tensor's device) is in
:mod:`repro_torch.kernels.conv3d.ops`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, VP, CudaLibrary

Tensor = torch.Tensor

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# output channels (OB) and frames (RT) one thread owns: the instantiated
# values of csrc/conv3d.cu (9 = the paper's O, 8 = C3D's 16 in two
# groups; 3 = the paper's and C3D's OT of 9 and 6; 5 = long streams)
OB_CHOICES = (1, 4, 8, 9)
RT_CHOICES = (1, 3, 5)
MAX_THREADS = 256
MAX_SMEM = 232448  # bytes of dynamic shared memory a Hopper block may take
SMS = 132
FILL_THREADS = SMS * 512  # resident threads at which the card counts as full

_LIB = CudaLibrary(
    "conv3d",
    Path(__file__).resolve().parent / "csrc",
    {"conv3d_fwd": [VP] * 3 + [I32] * 16 + [VP]},
)
build = _LIB.build


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the instantiation (``ob``, ``rt``), the block tile
    (``bh`` rows × ``bw`` columns × ``ntt`` frame tiles of ``rt``), the
    block size, the grid and the dynamic shared memory in bytes."""

    ob: int
    rt: int
    bh: int
    bw: int
    ntt: int
    threads: int
    blocks: int
    smem: int


def _smem(ob: int, rt: int, bh: int, bw: int, ntt: int, kw: int, kt: int) -> int:
    """Shared bytes of one block, as ``csrc/conv3d.cu`` lays them out: the
    input slab (frame stride padded to odd) and the row's weights with the
    channel group padded to a multiple of 4."""
    xs = bh * (bw + kw - 1) * ((ntt * rt + kt - 1) | 1)
    return 4 * ((xs + 3) // 4 * 4 + (ob + 3) // 4 * 4 * kw * kt)


def _cost(B: int, O: int, OH: int, OW: int, OT: int, ob: int, rt: int) -> float:
    """Relative time of an (ob, rt) choice: the padded work's per-tap issue
    slots (ob·rt FMAs and rt + ob/4 shared loads) or its shared-memory
    wavefronts (one per load, four FMA issues' worth), whichever is
    larger, over the share of the card the thread count fills."""
    groups, tiles = -(-O // ob), -(-OT // rt)
    loads = rt + -(-ob // 4)
    per_tap = max(ob * rt + loads, 4 * loads)
    fill = min(1.0, B * groups * OH * OW * tiles / FILL_THREADS)
    return groups * tiles * per_tap / fill


def plan(x_shape, w_shape) -> Plan:
    """The launch for x (B, C, H, W, T) against w (O, C, kh, kw, kt).

    Raises ``ValueError`` when no tile of this kernel fits the shapes
    (one kernel row's weights alone over the shared-memory limit)."""
    B, C, H, W, T = (int(n) for n in x_shape)
    O, _, kh, kw, kt = (int(n) for n in w_shape)
    OH, OW, OT = H - kh + 1, W - kw + 1, T - kt + 1
    ob, rt = min(
        ((ob, rt) for ob in OB_CHOICES for rt in RT_CHOICES),
        key=lambda c: (_cost(B, O, OH, OW, OT, *c), -c[0], -c[1]),
    )
    # columns in balanced tiles of at most 32; then frame tiles, then rows
    bw = -(-OW // -(-OW // 32))
    ntt = min(-(-OT // rt), max(1, MAX_THREADS // bw))
    bh = min(OH, max(1, MAX_THREADS // (bw * ntt)))

    def blocks(bh, ntt):
        return B * -(-O // ob) * -(-OH // bh) * -(-OW // bw) * -(-OT // (ntt * rt))

    # spread over the card: fewer rows per block while the grid is short
    while bh > 1 and blocks(bh, ntt) < 2 * SMS:
        bh = -(-bh // 2)
    while _smem(ob, rt, bh, bw, ntt, kw, kt) > MAX_SMEM and (bh > 1 or ntt > 1 or bw > 1):
        if bh > 1:
            bh = -(-bh // 2)
        elif ntt > 1:
            ntt = -(-ntt // 2)
        else:
            bw = -(-bw // 2)
    smem = _smem(ob, rt, bh, bw, ntt, kw, kt)
    if smem > MAX_SMEM:
        raise ValueError(
            f"conv3d kernel: a {kw}x{kt} kernel row needs {smem} bytes of shared "
            f"memory, over the {MAX_SMEM} a block may take"
        )
    threads = -(-(bh * bw * ntt) // 32) * 32
    return Plan(ob, rt, bh, bw, ntt, threads, blocks(bh, ntt), smem)


def flops(x_shape, w_shape) -> int:
    """Multiply-adds of a valid correlation, counted as two operations."""
    B, C, H, W, T = x_shape
    O, _, kh, kw, kt = w_shape
    return 2 * B * O * (H - kh + 1) * (W - kw + 1) * (T - kt + 1) * C * kh * kw * kt


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    _build.reset(conv3d_cuda)


def conv3d_cuda(x: Tensor, w: Tensor) -> Tensor:
    """B4: the valid 3-D correlation of :func:`ref.conv3d_ref`.

    x (B, C, H, W, T) and w (O, C, kh, kw, kt): one dtype, float32 or
    bfloat16, contiguous CUDA tensors on one device; the kernel must fit
    the volume.  Sums in float32; returns (B, O, OH, OW, OT) in x's
    dtype."""
    if x.dtype not in DTYPES:
        raise ValueError(f"no kernel for dtype {x.dtype}; built for {sorted(map(str, DTYPES))}")
    _build.require(x, "x", x.dtype, 5)
    _build.require(w, "w", x.dtype, 5)
    if x.device != w.device:
        raise ValueError(f"x on {x.device} and w on {w.device}: one device only")
    B, C, H, W, T = x.shape
    O, Cw, kh, kw, kt = w.shape
    if Cw != C:
        raise ValueError(f"w has {Cw} input channels, x has {C}")
    OH, OW, OT = H - kh + 1, W - kw + 1, T - kt + 1
    if min(B, C, O, kh, kw, kt, OH, OW, OT) < 1:
        raise ValueError(f"no valid correlation of x {tuple(x.shape)} with w {tuple(w.shape)}")
    if max(*x.shape, *w.shape) >= 2**31:
        raise ValueError("a dimension is outside the kernel's 32-bit sizes")
    p = plan(x.shape, w.shape)
    if p.blocks >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} needs {p.blocks} blocks, over the grid's 2^31")
    y = torch.empty((B, O, OH, OW, OT), dtype=x.dtype, device=x.device)
    rc = _LIB.lib().conv3d_fwd(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        B, C, H, W, T, O, kh, kw, kt, DTYPES[x.dtype],
        p.ob, p.rt, p.bh, p.bw, p.ntt, p.threads, _build.stream(),
    )
    _build.check(rc, "conv3d_fwd")
    _build.count(conv3d_cuda)
    return y


conv3d_cuda.launches = 0
