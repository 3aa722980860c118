"""Three-term roofline of a counted step on the H100 (the port's twin of
``repro.launch.roofline``).  All terms in seconds per step, per card:

  compute    = sum over FLOP classes of the class's FLOPs / the card's
               peak for that class (``PEAK_BY_CLASS``)
  memory     = HBM bytes / HBM bandwidth
  collective = sum over mesh axes of the axis's collective wire bytes /
               the bandwidth of the wire its groups use (``axis_bandwidth``)

FLOPs, bytes and classes come from ``launch.op_analysis`` (an
``OpCounter`` around the step).  The constants are the H100 SXM 80 GB's
dense (no sparsity) peaks: HBM3 3.35e12 B/s, bf16 tensor cores 989e12
FLOP/s, TF32 tensor cores 495e12 (a 3xTF32 product runs three, so a
third of it), float32 outside the tensor cores 67e12 (a float32 GEMM
with TF32 off runs there too).  The card has two wires: NVLink, 450e9
B/s per direction, among the 8 cards of a node, and one 400 Gb/s NDR
InfiniBand port, 50e9 B/s, to every other node.

**The collective term** (the twin of ``parse_collectives``).  The port
has no partitioner and no HLO, so :func:`plan_collectives` plans the
collectives that the reference's SPMD partitioner emits for one mesh
position from what the per-device step does (:func:`trace_collectives`)
and from the parameters' shardings, with the reference's wire model
(all-gather: result bytes; reduce-scatter: operand bytes; all-reduce:
2 x result bytes; all-to-all and collective-permute: result bytes):

  * tensor parallelism: an all-reduce over ``model`` of the output of
    every matmul (and embedding lookup) that contracts a parameter dim
    the per-device program cut over ``model`` — the row-parallel
    projections in the forward, the column-parallel ones' input
    gradients in the backward (those of one input summed first, one
    all-reduce), each remat recompute again;
  * an all-gather over ``model`` of each activation the program
    gathers whole from its cut columns (:func:`gather_model`), and its
    reduce-scatter in the backward;
  * activation sites (``sharding.record_constraints``): an all-to-all
    over ``model`` for each activation laid out by ``expert`` (the MoE
    dispatch and combine), a reduce-scatter and an all-gather over
    ``model`` for each residual sequence-sharded over it
    (``seq_shard``); each forward site again in the backward;
  * FSDP: an all-gather over ``data`` of every weight stored cut over
    ``data`` at each forward use (a remat recompute uses it again), and
    the gradients' reduction over ``data`` (a reduce-scatter; an
    all-reduce for a weight stored whole), once a step or, with
    ``grads_per_micro``, once a microbatch; on a multi-pod mesh an
    all-reduce over ``pod`` of each data shard.

What the plan leaves out: the cross-entropy's softmax statistics over a
vocab-sharded ``model`` axis, XLA's own re-layouts (the
collective-permutes and all-to-alls it adds between differently
sharded producers and consumers), and any overlap of a collective with
compute.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable

import torch
from torch.utils import checkpoint as _ckpt
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

from repro_torch.distributed import sharding as shd
from repro_torch.launch import op_analysis
from repro_torch.launch.op_analysis import BF16_TC, F32_CORE, F32_GEMM, TF32X3, Analysis, KernelCost

Tensor = torch.Tensor
aten = torch.ops.aten

HBM_BW = 3.35e12  # B/s
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor cores
PEAK_FLOPS_TF32 = 495e12  # dense TF32 tensor cores
PEAK_FLOPS_F32 = 67e12  # float32 outside the tensor cores
NVLINK_BW = 450e9  # B/s per direction, within a node
IB_BW = 50e9  # B/s: one 400 Gb/s NDR InfiniBand port per card, across nodes
NODE_CARDS = 8  # cards on one NVLink switch
DEVICE_MEMORY_BYTES = 80 * 10**9  # the card's rated HBM

PEAK_BY_CLASS = {
    BF16_TC: PEAK_FLOPS_BF16,
    F32_GEMM: PEAK_FLOPS_F32,
    TF32X3: PEAK_FLOPS_TF32 / 3,
    F32_CORE: PEAK_FLOPS_F32,
}


@dataclasses.dataclass
class Roofline:
    flops: float  # per device per step
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float  # 6·N·D (or 2·N·D serve) across the whole job
    useful_flops_ratio: float  # MODEL_FLOPS / (counted FLOPs × chips)
    collective_counts: dict[str, int]
    collective_bytes_by_kind: dict[str, int]
    flops_by_class: dict[str, float]
    collective_bytes_by_axis: dict[str, int]

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def axis_bandwidth(mesh_shape: dict[str, int], axis: str) -> float:
    """The wire bandwidth of the groups of ``axis`` on a mesh laid out
    row-major over consecutive cards (its last axis fastest): NVLink when
    each group lies inside one node of ``NODE_CARDS`` cards, else
    InfiniBand.  A group of ``axis`` spans the axis's size times every
    faster axis's size in consecutive cards."""
    span = 1
    for name in reversed(list(mesh_shape)):
        span *= mesh_shape[name]
        if name == axis:
            return NVLINK_BW if span <= NODE_CARDS and NODE_CARDS % span == 0 else IB_BW
    raise ValueError(f"axis {axis!r} is not an axis of the mesh {mesh_shape}")


def analyze(
    analysis: Analysis, n_chips: int, model_flops_total: float, mesh_shape: dict[str, int] | None = None
) -> Roofline:
    """The three-term roofline of a step counted by ``op_analysis``.
    ``model_flops_total``: the 6·N·D-style useful FLOPs of the whole job's
    step; ``mesh_shape`` (axis → size, major first) prices each axis's
    collective bytes on its wire."""
    by_axis = analysis.collective_bytes_by_axis
    if by_axis and mesh_shape is None:
        raise ValueError("collective bytes by mesh axis need the mesh's shape")
    compute_s = sum(f / PEAK_BY_CLASS[cls] for cls, f in analysis.flops_by_class.items())
    memory_s = analysis.hbm_bytes / HBM_BW
    collective_s = sum(b / axis_bandwidth(mesh_shape, ax) for ax, b in by_axis.items())
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    total = analysis.flops * n_chips
    return Roofline(
        flops=analysis.flops,
        hbm_bytes=analysis.hbm_bytes,
        collective_bytes=float(analysis.total_collective_bytes),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops_total,
        useful_flops_ratio=model_flops_total / total if total else 0.0,
        collective_counts={k: int(v) for k, v in analysis.collective_counts.items()},
        collective_bytes_by_kind={k: int(v) for k, v in analysis.collective_bytes.items()},
        flops_by_class=dict(analysis.flops_by_class),
        collective_bytes_by_axis={k: int(v) for k, v in by_axis.items()},
    )


def kernel_bound_s(cost: KernelCost, peak: float | None = None) -> tuple[float, str]:
    """The least time the card could take for one kernel call: the larger
    of its bytes over HBM bandwidth and its FLOPs over ``peak`` (default:
    the peak of its class), with which of the two it is."""
    t_bytes = cost.bytes / HBM_BW
    t_ops = cost.flops / (peak or PEAK_BY_CLASS[cost.cls])
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# the collective term
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveStats:
    """The reference's ``CollectiveStats``, with the wire bytes by mesh
    axis beside them by kind."""

    counts: dict[str, int]
    bytes_by_kind: dict[str, int]
    bytes_by_axis: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, axis: str, wire: int, times: int = 1) -> None:
        if times:
            self.counts[kind] = self.counts.get(kind, 0) + times
            self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + wire * times
            self.bytes_by_axis[axis] = self.bytes_by_axis.get(axis, 0) + wire * times

    def fill(self, analysis: Analysis) -> None:
        """Write these collectives into ``analysis``'s collective fields."""
        analysis.collective_counts = dict(self.counts)
        analysis.collective_bytes = dict(self.bytes_by_kind)
        analysis.collective_bytes_by_axis = dict(self.bytes_by_axis)


@dataclasses.dataclass
class CollectiveTrace:
    """What one traced run of a per-device program hands the plan:
    ``allreduce`` the output bytes of each op that contracted a
    model-cut parameter dim, ``allgather`` the result bytes of each
    :func:`gather_model` and whether the forward (not a recompute) ran
    it, ``sites`` each ``constrain`` call's
    ``(shape, dtype, logical axes, spec)`` (the first ``n_fwd`` of the
    forward, the rest of remat recomputes), ``uses`` each parameter's
    forward uses (its module's calls), ``backward`` whether the run
    differentiated."""

    allreduce: list[int]
    allgather: list[tuple[int, bool]]
    sites: list[tuple]
    n_fwd: int
    uses: dict[str, int]
    backward: bool


def _sid(t: Tensor) -> int:
    return t.untyped_storage()._cdata


_MM_OPERANDS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2), aten.baddbmm: (1, 2)}


class _Contractions(TorchDispatchMode):
    """Finds the partial sums of a per-device program: the output of
    every matmul that contracts, and every lookup that indexes, a dim
    that ``split`` says the program cut over ``model``.  A partial sum
    stays one through views and through adding another partial sum (the
    backward's input gradients of the projections that read one
    activation add up before they reduce); its first other use is where
    it is all-reduced, and ``allreduce`` notes its bytes.  A parameter's
    dtype copies (``.to``) stand for it."""

    def __init__(self, params: dict[str, Tensor], split: dict[str, tuple[int, ...]]):
        super().__init__()
        self.params, self.split = params, split
        self.owner = {_sid(p): name for name, p in params.items() if split.get(name)}
        self.partial: dict[int, Tensor] = {}
        self.allreduce: list[int] = []
        self.allgather: list[tuple[int, bool]] = []
        self.forward = True  # False once the backward (and its recomputes) runs
        self._keep: list[Tensor] = []  # copies stay alive, so their storages stay theirs

    def _cut(self, t: Tensor, dim: int) -> bool:
        name = self.owner.get(_sid(t)) if isinstance(t, Tensor) else None
        if name is None:
            return False
        p = self.params[name]
        return any(p.stride(j) == t.stride(dim) and p.shape[j] == t.shape[dim]
                   for j in self.split[name])

    def _reduce(self, key: int) -> None:
        t = self.partial.pop(key)
        self.allreduce.append(t.numel() * t.element_size())

    def reduce_all(self) -> None:
        for key in list(self.partial):
            self._reduce(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if op_analysis._kind(func) == "free":
            return out  # a view of a partial sum is one (it shares the storage)
        packet = func.overloadpacket
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, Tensor)]
        held = {_sid(t) for t in ins if _sid(t) in self.partial}
        if held and packet in (aten.add, aten.add_) and len(held) == len(ins) == 2:
            for key in held:  # two partial sums add up to one
                self.partial.pop(key)
            self.partial[_sid(out)] = out
            return out
        for key in held:
            self._reduce(key)
        if packet in (aten._to_copy, aten.clone):
            src = args[0]
            if (_sid(src) in self.owner and out.shape == src.shape and out.stride() == src.stride()):
                self.owner[_sid(out)] = self.owner[_sid(src)]
                self._keep.append(out)
            return out
        if packet in _MM_OPERANDS:
            i, j = _MM_OPERANDS[packet]
            a, b = args[i], args[j]
            cut = self._cut(a, a.dim() - 1) or self._cut(b, b.dim() - 2)
        elif packet is aten.embedding:
            cut = self._cut(args[0], 0)
        elif packet is aten.index:
            cut = any(ix is not None and self._cut(args[0], d) for d, ix in enumerate(args[1]))
        else:
            cut = False
        if cut:
            self.partial[_sid(out)] = out
        return out


def gather_model(t: Tensor, ways: int) -> Tensor:
    """``t``'s last dim gathered whole from ``ways`` cuts over ``model``
    (here: ``t`` repeated, the count's stand-in for the other cards'
    columns); inside :func:`trace_collectives` an all-gather of the
    result."""
    out = t.repeat(*([1] * (t.dim() - 1)), ways)
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _Contractions):
            mode.allgather.append((out.numel() * out.element_size(), mode.forward))
    return out


def _uses(name: str, calls: collections.Counter) -> int:
    """Calls of the nearest called module holding parameter ``name``
    (its own, then its ancestors', the root last), or 1."""
    path = name.split(".")[:-1]
    for k in range(len(path), -1, -1):
        n = calls.get(".".join(path[:k]), 0)
        if n:
            return n
    return 1


def trace_collectives(
    forward: Callable[[], Any],
    model: torch.nn.Module,
    split: dict[str, tuple[int, ...]],
    mesh,
    rules: shd.Rules,
    backward: bool,
) -> CollectiveTrace:
    """Run ``forward`` (and, with ``backward``, the gradients of its
    scalar result with respect to ``model``'s trainable parameters)
    inside ``activate(mesh, rules)`` and note what the collective plan
    needs (:class:`CollectiveTrace`).  ``split`` gives, by parameter
    name, the dims the program cut over ``model``.  Remat recomputes run
    whole (checkpoint early stop off), as the reference's do."""
    params = dict(model.named_parameters())
    calls: collections.Counter = collections.Counter()
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: calls.update([name]))
             for name, m in model.named_modules()]
    mode = _Contractions(params, split)
    try:
        with shd.activate(mesh, rules), shd.record_constraints() as sites, \
                _ckpt.set_checkpoint_early_stop(False), mode:
            out = forward()
            n_fwd = len(sites)
            mode.forward = False
            if backward:
                torch.autograd.grad(out, [p for p in params.values() if p.requires_grad])
        mode.reduce_all()  # a partial sum no op read: the step's outputs
    finally:
        for h in hooks:
            h.remove()
    return CollectiveTrace(mode.allreduce, mode.allgather, list(sites), n_fwd,
                           {n: _uses(n, calls) for n in params}, backward)


def plan_collectives(
    trace: CollectiveTrace,
    mesh_shape: dict[str, int],
    *,
    weights: dict[str, tuple[int, bool]],
    grads: dict[str, int] | None = None,
    n_micro: int = 1,
    grads_per_micro: bool = False,
    experts_cut: bool = False,
) -> CollectiveStats:
    """The collectives of one step of one mesh position (the module
    docstring's plan), ``trace`` being one microbatch's run.

    ``weights``: by parameter name, the bytes of the weight as the
    program computes with it (whole over ``data``) and whether it is
    stored cut over ``data`` (FSDP); ``grads`` (training): by name, the
    bytes of the gradient the data ranks reduce; ``experts_cut``: whether
    the per-device program holds 1/``model`` of the experts."""
    stats = CollectiveStats({}, {})
    size = {a: mesh_shape.get(a, 1) for a in ("pod", "data", "model")}
    if size["model"] > 1:
        for nbytes in trace.allreduce:
            stats.add("all-reduce", "model", 2 * nbytes, n_micro)
        for nbytes, forward in trace.allgather:
            stats.add("all-gather", "model", nbytes, n_micro)
            if forward and trace.backward:
                stats.add("reduce-scatter", "model", nbytes, n_micro)
        for i, (shape, dtype, axes, spec) in enumerate(trace.sites):
            times = n_micro * (2 if trace.backward and i < trace.n_fwd else 1)
            nbytes = math.prod(shape) * dtype.itemsize
            if experts_cut and len(axes) > 1 and axes[1] == "expert":
                stats.add("all-to-all", "model", nbytes, times)
            if "seq_model" in axes and spec[axes.index("seq_model")] == "model":
                stats.add("reduce-scatter", "model", nbytes, times)
                stats.add("all-gather", "model", nbytes, times)
    if size["data"] > 1:
        for name, (nbytes, fsdp) in weights.items():
            if fsdp:
                stats.add("all-gather", "data", nbytes, trace.uses[name] * n_micro)
    for name, nbytes in (grads or {}).items():
        times = n_micro if grads_per_micro else 1
        fsdp = weights[name][1]
        if size["data"] > 1:
            if fsdp:
                stats.add("reduce-scatter", "data", nbytes, times)
            else:
                stats.add("all-reduce", "data", 2 * nbytes, times)
        if size["pod"] > 1:
            shard = nbytes // size["data"] if fsdp else nbytes
            stats.add("all-reduce", "pod", 2 * shard, times)
    return stats
