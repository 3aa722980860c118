"""Op-level FLOP and byte counts of what a step runs: the port's twin of
``repro.launch.hlo_analysis``.

The reference parses the compiled HLO of a step.  The port has no
compiled program: eager PyTorch runs one kernel per aten op, so
:class:`OpCounter` (a ``TorchDispatchMode``) counts each aten op as it
runs, on any device, ``meta`` included, and yields an :class:`Analysis`
with the reference's fields (``flops``, ``hbm_bytes``, ``op_flops``,
``op_bytes``, ``collective_bytes``, ``collective_counts``).  The
conventions are the reference's (its module docstring and
``analyze_computation``), so that one micro-program counts the same on
both sides:

  * matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``_scaled_dot_product_*``, ``convolution`` and their backward):
    2 x output elements x contraction length; bytes = inputs + outputs;
  * FFTs: 5 n log2 n FLOPs, n the result's elements; 2 x result bytes;
  * every other op that computes: its output elements, bytes = inputs
    + outputs;
  * views, metadata and aliasing ops cost nothing, and a consumer of a
    view reads the view's bytes, not its base's (a broadcast dimension
    is read once);
  * in-place updates of a window (``copy_``, ``index_put_``,
    ``scatter_``, ``index_add_``, ...) count 2 x the update's bytes.

What has no twin: while-loop trip counts (the port's loops run in
Python, so every iteration's ops are counted as they run) and fusion
(no aten op is fused in eager mode, so every operand and result is HBM
traffic).  Every op is also charged to a FLOP class by the dtype and op
that do it (``Analysis.flops_by_class``): bf16 / fp16 tensor-core
GEMMs, float32 GEMMs (TF32 off, as the port runs them), 3xTF32 (kernels
B4 and B5) and float32 CUDA-core work (elementwise, reductions,
softmax, FFTs, integer work).

**Kernels are counted by their own formula.**  Each wrapper of B1-B6
(``kernels/{stmul,conv3d,ssd,flash}/ops.py``) runs its routing
function under :func:`counted_kernel`, which reports one op (its name,
:func:`kernel_cost`'s FLOPs, bytes and class) and counts none of the
ops inside it, so a call counts the same whether the card's kernel, the
CPU's plain version or the ``meta`` route computes it.  The backward of
B4, B5 and B6 is their plain version under autograd; each of its ops is
counted under a :func:`bucket` of its own (``flash_bwd(plain)``, ...).

The counter also keeps the high-water mark of live bytes of the tensors
made while it counts (``Analysis.peak_live_bytes``), freed through weakref
finalizers on their storages: the twin of ``memory_analysis()``'s temp
size.  A kernel's workspace is not in it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Any, Callable

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

Tensor = torch.Tensor
aten = torch.ops.aten

# FLOP classes: who does the arithmetic on the card
BF16_TC = "bf16_tensor_core"  # bf16 / fp16 GEMMs on the tensor cores
F32_GEMM = "f32_gemm"  # float32 GEMMs, TF32 off
TF32X3 = "3xtf32"  # float32 products as three TF32 tensor-core products (B4, B5)
F32_CORE = "f32_cuda_core"  # elementwise, reductions, softmax, FFTs, integer work
FLOP_CLASSES = (BF16_TC, F32_GEMM, TF32X3, F32_CORE)

_HALF = (torch.bfloat16, torch.float16)


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    op_flops: dict = dataclasses.field(default_factory=dict)
    op_bytes: dict = dataclasses.field(default_factory=dict)
    op_counts: dict = dataclasses.field(default_factory=dict)
    flops_by_class: dict = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float
    bytes: float
    cls: str


def kernel_cost(name: str, **shape) -> KernelCost:
    """FLOPs, bytes (each input read once, each output written once) and
    FLOP class of one call of a hand-written kernel at ``shape``:

    ``spectral_mac`` (B1): B, O, C, F; ``spectral_mac_grouped`` (B2): B, C,
    F, o_start, n_out, itemsize (of the arena planes; only the arena rows
    the offsets read are counted); ``topk_readout`` (B3): R, L, k;
    ``conv3d`` (B4): x_shape, w_shape, dtype; ``ssd`` (B5): Bb, L (padded
    to the chunk), H, G, P, N, chunk; ``flash_fwd`` (B6): B, Sq, Sk, H, G,
    D, causal, dtype."""
    s = shape
    if name == "spectral_mac":
        B, O, C, F = s["B"], s["O"], s["C"], s["F"]
        return KernelCost(8 * B * O * C * F, (B * C * F + O * C * F + B * O * F) * 8, F32_CORE)
    if name == "spectral_mac_grouped":
        B, C, F, n = s["B"], s["C"], s["F"], s["n_out"]
        rows = len({o + j for o in s["o_start"] for j in range(n)})
        nbytes = B * C * F * 8 + 2 * rows * C * F * s["itemsize"] + B * n * F * 8
        return KernelCost(8 * B * n * C * F, nbytes, F32_CORE)
    if name == "topk_readout":
        R, L, k = s["R"], s["L"], s["k"]
        return KernelCost(0, R * L * 4 + L * 4 + R * k * 8, F32_CORE)
    if name == "conv3d":
        (B, C, H, W, T), (O, _, kh, kw, kt) = s["x_shape"], s["w_shape"]
        out = B * O * (H - kh + 1) * (W - kw + 1) * (T - kt + 1)
        flops = 2 * out * C * kh * kw * kt
        nbytes = (math.prod(s["x_shape"]) + math.prod(s["w_shape"]) + out) * s["dtype"].itemsize
        return KernelCost(flops, nbytes, BF16_TC if s["dtype"] in _HALF else TF32X3)
    if name == "ssd":
        # per (batch, chunk, group) the causal lower triangle of C·Bᵀ,
        # Q(Q+1)/2 dots of length N, shared by the group's H / G heads;
        # per (batch, chunk, head) the intra-chunk product (Q(Q+1)/2 rows
        # of P) and the state readout and update, 2QNP each
        Bb, L, H, G, P, N, Q = s["Bb"], s["L"], s["H"], s["G"], s["P"], s["N"], s["chunk"]
        nbytes = 4 * (2 * Bb * L * H * P + Bb * L * H + H + 2 * Bb * L * G * N + Bb * H * P * N)
        flops = Bb * (L // Q) * (G * Q * (Q + 1) * N + H * (Q * (Q + 1) * P + 4 * Q * N * P))
        return KernelCost(flops, nbytes, TF32X3)
    if name == "flash_fwd":
        # 4·D FLOPs per query-key pair the mask keeps (the causal
        # triangle, top-left aligned)
        B, Sq, Sk, H, G, D = s["B"], s["Sq"], s["Sk"], s["H"], s["G"], s["D"]
        n = min(Sq, Sk)
        pairs = n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk if s["causal"] else Sq * Sk
        nbytes = s["dtype"].itemsize * D * (2 * B * Sq * H + 2 * B * Sk * G)
        return KernelCost(4 * D * B * H * pairs, nbytes, BF16_TC if s["dtype"] in _HALF else F32_CORE)
    raise ValueError(f"no cost formula for kernel {name!r}")


# ---------------------------------------------------------------------------
# op kinds
# ---------------------------------------------------------------------------

_MM = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2), aten.baddbmm: (1, 2)}
_FFT = {aten._fft_r2c, aten._fft_c2r, aten._fft_c2c}
# no arithmetic and no traffic: metadata, aliasing and allocation
_FREE = {
    aten.detach, aten.alias, aten.lift_fresh, aten._unsafe_view, aten.empty, aten.empty_like,
    aten.empty_strided, aten.new_empty, aten.new_empty_strided, aten._local_scalar_dense,
    aten.set_, aten.resize_, aten.sym_size, aten.sym_stride, aten.sym_numel,
}
# in-place window updates -> the index of the update argument (None: self's window)
_UPDATE = {
    aten.copy_: None, aten.index_put_: 2, aten._index_put_impl_: 2, aten.scatter_: 3,
    aten.scatter_add_: 3, aten.scatter_reduce_: 3, aten.index_add_: 3, aten.index_copy_: 3,
    aten.masked_scatter_: 2,
}
# writes without reading: outputs only
_FILL = {aten.fill_, aten.zero_}


@functools.cache
def _kind(func) -> str:
    packet = func.overloadpacket
    if packet in _FREE:
        return "free"
    if any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns):
        return "free"  # a view
    if packet in _MM:
        return "mm"
    if packet in flop_counter.flop_registry:
        return "registry"
    if packet in _FFT:
        return "fft"
    if packet in _UPDATE:
        return "update"
    if packet in _FILL:
        return "fill"
    return "generic"


def nbytes(t: Tensor) -> int:
    """Bytes one read of ``t`` moves: its elements, a broadcast (stride 0)
    dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.dtype.itemsize


def _tensors(tree) -> list[Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, Tensor)]


def _gemm_class(t: Tensor) -> str:
    return BF16_TC if t.dtype in _HALF else F32_GEMM


def _cost(kind: str, func, args, kwargs, out) -> tuple[float, float, str]:
    """(FLOPs, bytes, class) of one counted op."""
    outs = _tensors(out)
    out_bytes = sum(t.numel() * t.dtype.itemsize for t in outs)
    if kind == "update":
        i = _UPDATE[func.overloadpacket]
        upd = args[0] if i is None or len(args) <= i or not isinstance(args[i], Tensor) else args[i]
        return float(upd.numel()), 2.0 * upd.numel() * args[0].dtype.itemsize, F32_CORE
    if kind == "fill":
        return float(sum(t.numel() for t in outs)), float(out_bytes), F32_CORE
    in_bytes = sum(nbytes(t) for t in _tensors((args, kwargs)))
    if kind == "mm":
        a, b = (args[i] for i in _MM[func.overloadpacket])
        return 2.0 * outs[0].numel() * a.shape[-1], float(in_bytes + out_bytes), _gemm_class(a)
    if kind == "registry":
        flops = flop_counter.flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
        return float(flops), float(in_bytes + out_bytes), _gemm_class(_tensors(args)[0])
    if kind == "fft":
        n = outs[0].numel()
        return 5.0 * n * math.log2(max(n, 2)), 2.0 * out_bytes, F32_CORE
    return float(sum(t.numel() for t in outs)), float(in_bytes + out_bytes), F32_CORE


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


class OpCounter(TorchDispatchMode):
    """Counts every aten op run while it is entered into ``self.analysis``.

    The mode is inherited by autograd's worker threads, so a backward run
    inside it is counted too.  Never time a step under it: counting costs
    host time per op."""

    def __init__(self):
        super().__init__()
        self.analysis = Analysis()
        self._quiet = 0  # > 0 while a counted kernel runs its route
        self._buckets: list[str] = []
        self._live = 0
        self._tracked: set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        kind = _kind(func)
        if kind == "free":
            return out
        self._add(self._buckets[-1] if self._buckets else func.overloadpacket.__name__,
                  *_cost(kind, func, args, kwargs, out))
        if kind not in ("update", "fill"):
            self._track(out)
        return out

    def _add(self, key: str, flops: float, nbytes_: float, cls: str) -> None:
        a = self.analysis
        a.flops += flops
        a.hbm_bytes += nbytes_
        a.op_flops[key] = a.op_flops.get(key, 0.0) + flops
        a.op_bytes[key] = a.op_bytes.get(key, 0.0) + nbytes_
        a.op_counts[key] = a.op_counts.get(key, 0) + 1
        a.flops_by_class[cls] = a.flops_by_class.get(cls, 0.0) + flops

    def _track(self, out) -> None:
        """Add the storages of ``out`` that are new to the live bytes."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._tracked:
                continue
            n = st.nbytes()
            self._tracked.add(key)
            self._live += n
            weakref.finalize(st, self._free, key, n).atexit = False
        if self._live > self.analysis.peak_live_bytes:
            self.analysis.peak_live_bytes = self._live

    def _free(self, key: int, n: int) -> None:
        self._tracked.discard(key)
        self._live -= n


def active_counter() -> OpCounter | None:
    """The innermost :class:`OpCounter` in force on this thread, if any."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


def counted_kernel(name: str, shape_of: Callable[..., dict]) -> Callable:
    """Decorator of a kernel wrapper's routing function: under an active
    counter the call counts as one op ``name`` at
    ``kernel_cost(name, **shape_of(*args, **kwargs))`` and the ops inside it
    are not counted; its outputs join the live bytes.  Without a counter
    it only checks for one."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            c = active_counter()
            if c is None or c._quiet:
                return fn(*args, **kwargs)
            cost = kernel_cost(name, **shape_of(*args, **kwargs))
            c._add(c._buckets[-1] if c._buckets else name, cost.flops, cost.bytes, cost.cls)
            c._quiet += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                c._quiet -= 1
            c._track(out)
            return out

        return wrapped

    return deco


class bucket:
    """Within the block every op an active counter counts is keyed
    ``name`` (a kernel's plain backward, say) instead of by its own name."""

    def __init__(self, name: str):
        self.name = name
        self._counter: OpCounter | None = None

    def __enter__(self):
        self._counter = active_counter()
        if self._counter is not None:
            self._counter._buckets.append(self.name)
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._counter is not None:
            self._counter._buckets.pop()
