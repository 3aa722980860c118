"""Hopper CUDA kernels of the direct 3-D correlation (B4) and their ctypes
wrapper.

Three hand-written kernels, one library: ``csrc/conv3d_tc.cu`` runs the
paper geometry's few-channel products on the tensor cores in 3xTF32
(``wgmma``), ``csrc/conv3d_igemm.cu`` many-channel 3x3x3 layers (C3D's)
as an implicit GEMM on the tensor cores in 3xTF32 (``wgmma`` and TMA,
reading a zero border itself, with bias and ReLU fused), and
``csrc/conv3d.cu`` the rest on the float32 FMA pipes (the note at the
top of each says what it replaces, what bounds it on the card and how
its design answers that).  :func:`route`, a pure function of the shapes
and the dtype, says which one a call takes: ``"wgmma"`` for float32
with kt = 8 frames and at most 9 output channels (the paper geometry's
batch and streams), ``"igemm"`` for float32 3x3x3 kernels with a
multiple of 64 output channels over a multiple of 32 input channels, or
over at most 3 (C3D's eight layers), ``"fma"`` for the rest (bfloat16,
other kernels, few channels).
:mod:`repro_torch.kernels._build` compiles all three with ``nvcc`` for
``sm_90a`` on first use and loads them with ``ctypes``; :func:`build`
does it eagerly and reports the compile.

:func:`plan` (FMA), :func:`tc_plan` (``wgmma``) and :func:`igemm_plan`
(``igemm``) choose each kernel's tile from the shapes alone; they are
plain Python, so the CPU tests check that the tiles cover every output
once and fit in shared memory.

:func:`conv3d_cuda` takes CUDA tensors only, checks device, dtype,
shape, contiguity and channel agreement, allocates its output (and a
tensor-core route's workspace) with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch reported an
error, and adds one to the counter of its route in ``route_launches``
and to ``launches``, their sum.  A zero border, a bias, a ReLU and
channels-last tensors are taken by the ``igemm`` route only.
Its plain version is :func:`repro_torch.kernels.conv3d.ref.conv3d_ref`;
the routing between the two (by the tensor's device) is in
:mod:`repro_torch.kernels.conv3d.ops`.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, I64, VP, CudaLibrary

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

# the implicit-GEMM kernel (csrc/conv3d_igemm.cu): BM output positions
# and BN in {64, 128} output channels a block, IG_KC channels of one tap a
# stage, a ring of IG_RING bytes of stages (A rows and w's hi and lo rows,
# 128 bytes each), 2 consumer warpgroups and a producer warp
IG_BM, IG_KC, IG_RING = 128, 32, 196608
IG_THREADS = 288
ROUTES = ("wgmma", "igemm", "fma")

_LIB = CudaLibrary(
    "conv3d",
    Path(__file__).resolve().parent / "csrc",
    {
        "conv3d_fwd": [VP] * 3 + [I32] * 16 + [VP],
        "conv3d_tc_fwd": [VP] * 4 + [I32] * 11 + [VP],
        "conv3d_igemm_fwd": [VP] * 5 + [I32] * 5 + [I64] * 5 + [I32] * 12 + [VP],
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


def _igemm_takes(w_shape) -> bool:
    """The implicit-GEMM kernel's shapes: 3x3x3 taps, output channels a
    multiple of 64, input channels a multiple of 32 (one tap's 32-channel
    rows) or at most 3 (the taps gathered into 32 channels)."""
    O, C, kh, kw, kt = (int(n) for n in w_shape)
    return (kh, kw, kt) == (3, 3, 3) and O % 64 == 0 and (C % IG_KC == 0 or C * kh * kw <= IG_KC)


def route(x_shape, w_shape, dtype: torch.dtype) -> str:
    """Which kernel computes the valid correlation of x (B, C, H, W, T)
    with w (O, C, kh, kw, kt), x counted with any zero border:
    ``"wgmma"`` (``csrc/conv3d_tc.cu``) for float32 with kt = 8 and at most
    9 output channels when its tile fits; ``"igemm"``
    (``csrc/conv3d_igemm.cu``) for float32 3x3x3 kernels that
    :func:`_igemm_takes`; else ``"fma"`` (``csrc/conv3d.cu``)."""
    O, kt = int(w_shape[0]), int(w_shape[4])
    if dtype == torch.float32 and kt == TC_KT and O <= TC_MAX_O:
        if _tc_tile(x_shape, w_shape) is not None:
            return "wgmma"
    if dtype == torch.float32 and _igemm_takes(w_shape):
        return "igemm"
    return "fma"


@dataclasses.dataclass(frozen=True)
class IgemmPlan:
    """One call of the implicit-GEMM kernel: whether the taps are gathered
    into channels first (``fold``), the block's output channels ``bn``, its
    box of output positions (``bh`` rows x ``bw`` columns x ``bt``
    frames, at most ``IG_BM``), the ring's stages (as many as fit; at
    ``bn`` 64 at most the call's K / 32), the grid, the block size, the dynamic shared
    memory in bytes and the workspace in floats (w's hi and lo planes;
    with ``fold`` the gathered x too)."""

    fold: bool
    bn: int
    bh: int
    bw: int
    bt: int
    stages: int
    blocks: int
    threads: int
    smem: int
    workspace_floats: int


@functools.lru_cache(maxsize=256)
def _igemm_box(OH: int, OW: int, OT: int) -> tuple[int, int, int]:
    """The box (bh, bw, bt) of at most IG_BM output positions that tiles
    the volume in the fewest blocks; among those the longest runs of
    frames, then of columns."""
    best = None
    for bt in range(1, min(OT, IG_BM) + 1):
        for bw in range(1, min(OW, IG_BM // bt) + 1):
            bh = min(OH, IG_BM // (bt * bw))
            key = (-(-OH // bh) * -(-OW // bw) * -(-OT // bt), -bt, -bw)
            if best is None or key < best[0]:
                best = (key, (bh, bw, bt))
    return best[1]


def igemm_plan(x_shape, w_shape, pad: int = 0) -> IgemmPlan:
    """The implicit-GEMM kernel's launch for x (B, C, H, W, T) with a zero
    border of ``pad`` against w (O, C, 3, 3, 3); raises ``ValueError``
    for shapes :func:`route` does not send there."""
    B, C, H, W, T = (int(n) for n in x_shape)
    O, _, kh, kw, kt = (int(n) for n in w_shape)
    if not _igemm_takes(w_shape):
        raise ValueError(f"no implicit-GEMM tile for x {tuple(x_shape)} and w {tuple(w_shape)}")
    OH, OW, OT = H + 2 * pad - kh + 1, W + 2 * pad - kw + 1, T + 2 * pad - kt + 1
    fold = C % IG_KC != 0
    bn = 128 if O % 128 == 0 else 64
    bh, bw, bt = _igemm_box(OH, OW, OT)
    stage = IG_BM * 128 + 2 * bn * 128
    K = kt * IG_KC if fold else kh * kw * kt * C
    stages = IG_RING // stage if bn == 128 else min(IG_RING // stage, K // IG_KC)
    blocks = B * -(-OH // bh) * -(-OW // bw) * -(-OT // bt) * (O // bn)
    ws = 2 * O * K + (B * OH * OW * T * IG_KC if fold else 0)
    return IgemmPlan(fold, bn, bh, bw, bt, stages, blocks, IG_THREADS,
                     stages * stage + 2 * stages * 8 + 1024, ws)


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
    """Set the kernel's launch counters to 0."""
    _build.reset(conv3d_cuda)


def _igemm(x: Tensor, w: Tensor, pad: int, bias: Tensor | None, relu: bool,
           channels_last: bool) -> Tensor:
    """The ``igemm`` route: w laid out K-major (its taps gathered into 32
    channels with ``fold``), x channels-last (or read through its strides
    with ``fold``), y channels-last, then as the caller laid x out."""
    xv = x.permute(0, 4, 1, 2, 3) if channels_last else x  # (B, C, H, W, T)
    B, C, H, W, T = xv.shape
    O, _, kh, kw, kt = w.shape
    p = igemm_plan(xv.shape, w.shape, pad)
    if p.blocks >= 2**31:
        raise ValueError(f"x {tuple(xv.shape)} needs {p.blocks} blocks, over the grid's 2^31")
    if p.fold:
        taps = w.permute(0, 4, 2, 3, 1).reshape(O, kt, kh * kw * C)
        wk = torch.nn.functional.pad(taps, (0, IG_KC - kh * kw * C)).contiguous()
        xg = xv
    else:
        wk = w.permute(0, 2, 3, 4, 1).contiguous()
        xg = x.contiguous() if channels_last else xv.permute(0, 2, 3, 4, 1).contiguous()
        if xg.data_ptr() % 16:
            xg = xg.clone()
    if bias is not None:
        _build.require(bias, "bias", torch.float32, 1)
        if bias.shape[0] != O or bias.device != x.device:
            raise ValueError(f"bias {tuple(bias.shape)} on {bias.device}: want ({O},) on {x.device}")
    OH, OW, OT = H + 2 * pad - kh + 1, W + 2 * pad - kw + 1, T + 2 * pad - kt + 1
    y = torch.empty((B, OH, OW, OT, O), dtype=x.dtype, device=x.device)
    ws = torch.empty(p.workspace_floats, dtype=torch.float32, device=x.device)
    rc = _LIB.lib().conv3d_igemm_fwd(
        xg.data_ptr(), wk.data_ptr(), 0 if bias is None else bias.data_ptr(), y.data_ptr(),
        ws.data_ptr(), B, C, H, W, T, *xg.stride() if p.fold else (0,) * 5,
        O, kh, kw, kt, pad, pad, pad, p.bh, p.bw, p.bt, int(p.fold), int(relu), _build.stream(),
    )
    _build.check(rc, "conv3d_igemm_fwd")
    return y if channels_last else y.permute(0, 4, 1, 2, 3).contiguous()


def conv3d_cuda(x: Tensor, w: Tensor, pad: int = 0, bias: Tensor | None = None,
                relu: bool = False, channels_last: bool = False) -> Tensor:
    """B4: the valid 3-D correlation of :func:`ref.conv3d_ref`, on the
    kernel :func:`route` names (a tensor-core route's wrapper call runs
    two or three launches: its splits, the products; it counts one).

    x (B, C, H, W, T) and w (O, C, kh, kw, kt): one dtype, float32 or
    bfloat16, CUDA tensors on one device; the kernel must fit the volume.
    Sums in float32; returns (B, O, OH, OW, OT) in x's dtype.  On the
    ``igemm`` route only: x read with a zero border of ``pad`` voxels on
    H, W and T, ``bias`` (O,) added, ReLU with ``relu``, and with
    ``channels_last`` x (B, H, W, T, C) and y (B, OH, OW, OT, O)."""
    if x.dtype not in DTYPES:
        raise ValueError(f"no kernel for dtype {x.dtype}; built for {sorted(map(str, DTYPES))}")
    for t, name in ((x, "x"), (w, "w")):  # contiguity is checked per route
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != x.dtype or t.ndim != 5:
            raise ValueError(f"{name} must be {x.dtype} with 5 dims, got {t.dtype} {tuple(t.shape)}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} and w on {w.device}: one device only")
    if channels_last:
        B, H, W, T, C = x.shape
    else:
        B, C, H, W, T = x.shape
    O, Cw, kh, kw, kt = w.shape
    if Cw != C:
        raise ValueError(f"w has {Cw} input channels, x has {C}")
    pad = int(pad)
    OH, OW, OT = H + 2 * pad - kh + 1, W + 2 * pad - kw + 1, T + 2 * pad - kt + 1
    if min(B, C, O, kh, kw, kt, OH, OW, OT) < 1 or pad < 0:
        raise ValueError(f"no valid correlation of x {tuple(x.shape)} with w {tuple(w.shape)}")
    if max(*x.shape, *w.shape) >= 2**31:
        raise ValueError("a dimension is outside the kernel's 32-bit sizes")
    r = route((B, C, H + 2 * pad, W + 2 * pad, T + 2 * pad), w.shape, x.dtype)
    if r == "igemm":
        y = _igemm(x, w, pad, bias, relu, channels_last)
        _build.count(conv3d_cuda, r)
        return y
    if pad or bias is not None or relu or channels_last:
        raise ValueError(f"the {r!r} route takes a valid correlation only: no border, bias, "
                         "ReLU or channels-last layout")
    _build.require(x, "x", x.dtype, 5)
    _build.require(w, "w", x.dtype, 5)
    tc = r == "wgmma"
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
    _build.count(conv3d_cuda, r)
    return y


conv3d_cuda.launches = 0
conv3d_cuda.route_launches = dict.fromkeys(ROUTES, 0)
