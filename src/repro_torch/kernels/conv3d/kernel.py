"""Hopper CUDA kernels of the direct valid 3-D correlation (B4) and their
ctypes wrapper.

Two hand-written kernels, one library: ``csrc/conv3d_tc.cu`` runs the
products on the tensor cores in 3xTF32 (``wgmma``), ``csrc/conv3d.cu`` on
the float32 FMA pipes (the note at the top of each says what it
replaces, what bounds it on the card and how its design answers that).
:func:`route`, a pure function of the shapes and the dtype, says which one
a call takes: the tensor-core kernel for float32 with kt = 8 frames and at
most 9 output channels (the paper geometry's batch and streams), the FMA
kernel for the rest (bfloat16, C3D's 3x3x3, other kt).
:mod:`repro_torch.kernels._build` compiles both with ``nvcc`` for
``sm_90a`` on first use and loads them with ``ctypes``; :func:`build`
does it eagerly and reports the compile.

:func:`plan` (FMA) and :func:`tc_plan` (tensor cores) choose each
kernel's tile from the shapes alone; they are plain Python, so the CPU
tests check that the tiles cover every output once and fit in shared
memory.

:func:`conv3d_cuda` takes CUDA tensors only, checks device, dtype,
shape, contiguity and channel agreement, allocates its output (and the
tensor-core route's split workspace) with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch reported an
error, and adds one to its ``launches`` counter.
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

# the tensor-core kernel (csrc/conv3d_tc.cu): kt of one k8 step, channels
# of its 24-row B, MT m64 column tiles per warpgroup, NWG warpgroups per
# block, TC_STEP_FLOATS floats of B per k step
TC_KT, TC_MAX_O = 8, 9
TC_MT, TC_NWG = 7, 2
TC_THREADS = 128 * TC_NWG
TC_ROWS = 64
TC_STEP_FLOATS = 24 * TC_KT

_LIB = CudaLibrary(
    "conv3d",
    Path(__file__).resolve().parent / "csrc",
    {
        "conv3d_fwd": [VP] * 3 + [I32] * 16 + [VP],
        "conv3d_tc_fwd": [VP] * 4 + [I32] * 11 + [VP],
    },
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


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """One call of the tensor-core kernel: a tile's rows (``bi`` output
    rows × ``bk`` frames, at most 64), the block size, the grid, the
    dynamic shared memory in bytes and the split workspace in floats."""

    bi: int
    bk: int
    threads: int
    blocks: int
    smem: int
    workspace_floats: int


def _tc_smem(bi: int, bk: int, kw: int) -> int:
    """Shared bytes of the tensor-core kernel, as ``csrc/conv3d_tc.cu``
    lays them out: two stages of the x slab's hi and lo planes (columns of
    bk + 7 frames rounded up to 4, each plane on 128 bytes) and kw k steps
    of B (on 256 bytes), two barriers, and 256 bytes of slack to align
    them."""
    nc = TC_NWG * TC_MT + kw - 1
    cs = -(-(bk + TC_KT - 1) // 4) * 4
    plane = -(-bi * nc * cs // 32) * 32
    xbytes = -(-8 * plane // 256) * 256
    stage = -(-(xbytes + 4 * kw * TC_STEP_FLOATS) // 256) * 256
    return 2 * stage + 16 + 256


def _tc_tile(x_shape, w_shape) -> tuple[int, int] | None:
    """The tile rows (bi, bk) that waste the fewest m64 rows among frame
    runs of OT (up to 64), 64, 32, 16 and 8, or None when none fits the
    shared memory."""
    _, _, H, _, T = (int(n) for n in x_shape)
    _, _, kh, kw, kt = (int(n) for n in w_shape)
    OH, OT = H - kh + 1, T - kt + 1
    best = None
    for bk in sorted({min(OT, TC_ROWS), 64, 32, 16, 8}, reverse=True):
        bi = max(1, min(OH, TC_ROWS // bk))
        used = OH * OT / (-(-OH // bi) * -(-OT // bk) * TC_ROWS)
        if _tc_smem(bi, bk, kw) <= MAX_SMEM and (best is None or used > best[0]):
            best = (used, bi, bk)
    return None if best is None else best[1:]


def route(x_shape, w_shape, dtype: torch.dtype) -> str:
    """Which kernel a call takes: ``"wgmma"`` (``csrc/conv3d_tc.cu``) for
    float32 with kt = 8 and at most 9 output channels when its tile fits,
    else ``"fma"`` (``csrc/conv3d.cu``)."""
    O, kt = int(w_shape[0]), int(w_shape[4])
    if dtype == torch.float32 and kt == TC_KT and O <= TC_MAX_O:
        if _tc_tile(x_shape, w_shape) is not None:
            return "wgmma"
    return "fma"


def tc_plan(x_shape, w_shape) -> TcPlan:
    """The tensor-core kernel's launch for x (B, C, H, W, T) against w
    (O, C, kh, kw, 8); raises ``ValueError`` for shapes :func:`route`
    does not send there."""
    B, C, H, W, T = (int(n) for n in x_shape)
    O, _, kh, kw, kt = (int(n) for n in w_shape)
    tile = _tc_tile(x_shape, w_shape) if kt == TC_KT and O <= TC_MAX_O else None
    if tile is None:
        raise ValueError(f"no tensor-core tile for x {tuple(x_shape)} and w {tuple(w_shape)}")
    bi, bk = tile
    OH, OW, OT = H - kh + 1, W - kw + 1, T - kt + 1
    blocks = B * -(-OH // bi) * -(-OW // (TC_NWG * TC_MT)) * -(-OT // bk)
    tp = -(-T // 4) * 4
    ws = 2 * B * C * H * W * tp + C * kh * kw * TC_STEP_FLOATS
    return TcPlan(bi, bk, TC_THREADS, blocks, _tc_smem(bi, bk, kw), ws)


def flops(x_shape, w_shape) -> int:
    """Multiply-adds of a valid correlation, counted as two operations."""
    B, C, H, W, T = x_shape
    O, _, kh, kw, kt = w_shape
    return 2 * B * O * (H - kh + 1) * (W - kw + 1) * (T - kt + 1) * C * kh * kw * kt


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    _build.reset(conv3d_cuda)


def conv3d_cuda(x: Tensor, w: Tensor) -> Tensor:
    """B4: the valid 3-D correlation of :func:`ref.conv3d_ref`, on the
    kernel :func:`route` names (the tensor-core route runs three
    launches: split x, split w, the products; it counts one).

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
    tc = route(x.shape, w.shape, x.dtype) == "wgmma"
    p = tc_plan(x.shape, w.shape) if tc else plan(x.shape, w.shape)
    if p.blocks >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} needs {p.blocks} blocks, over the grid's 2^31")
    y = torch.empty((B, O, OH, OW, OT), dtype=x.dtype, device=x.device)
    if tc:
        ws = torch.empty(p.workspace_floats, dtype=torch.float32, device=x.device)
        rc = _LIB.lib().conv3d_tc_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), ws.data_ptr(),
            B, C, H, W, T, O, kh, kw, kt, p.bi, p.bk, _build.stream(),
        )
    else:
        rc = _LIB.lib().conv3d_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            B, C, H, W, T, O, kh, kw, kt, DTYPES[x.dtype],
            p.ob, p.rt, p.bh, p.bw, p.ntt, p.threads, _build.stream(),
        )
    _build.check(rc, "conv3d_tc_fwd" if tc else "conv3d_fwd")
    _build.count(conv3d_cuda)
    return y


conv3d_cuda.launches = 0
