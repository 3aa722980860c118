"""Logical-axis sharding rules (port of the rule half of
``repro.distributed.sharding``).

Code names its tensors' dims by *logical* axes; a rules dict maps them
onto the mesh axes (single pod ``(data, model)``, multi-pod ``(pod,
data, model)``), so a change of parallel layout is a change of rules.
:func:`spec_for` resolves one shape against the rules and a mesh: an
axis whose size does not divide the dim is dropped (shape-aware
resolution), and a mesh axis serves at most one dim.

The serving rules put the ``grating`` axis (the arena's rows) on the
``model`` axis; the engine's mesh executor follows them without a
lookup, since its shard-tiled packing already cuts the arena into one
tile per model shard (``GratingPool.shards``).

Resolving needs only the mesh's ``shape`` (a dict of axis sizes), so a
:class:`~repro_torch.launch.mesh.LocalMesh` and the reference's
``jax.sharding.Mesh`` resolve alike.  Placing a tensor needs the
devices too: a :class:`NamedSharding` pairs a ``LocalMesh`` with a
spec (:func:`tree_shardings` makes a tree of them), and a
:class:`ShardedTensor` holds a tensor as its shards on the mesh's
devices, cut as ``jax.device_put`` cuts an array onto a
``jax.sharding.NamedSharding``.  ``checkpoint.restore_resharded``
restores training state onto them, and the training executor
(``launch.train``) moves it with :func:`all_gather` (every parameter's
whole tensor into a compute module) and :func:`reduce_scatter` (the data
ranks' gradients summed and cut into tiles), both plain tensor code.

:func:`activate` / :func:`constrain` are the reference's activation
constraints: model code names an activation's logical axes at the
reference's sites, and inside ``activate(mesh, rules)`` each call
resolves and checks its spec.  The port has no partitioner, so a
constraint never changes a value or a layout; :func:`record_constraints`
collects what the calls resolved, for a count of the collectives a
partitioner would add.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import TYPE_CHECKING, Any, Iterator, Sequence

import torch

if TYPE_CHECKING:
    from repro_torch.launch.mesh import LocalMesh

PyTree = Any

# logical axis -> mesh axis (or tuple of mesh axes)
Rules = dict[str, Any]


class PartitionSpec(tuple):
    """One entry per dim: a mesh-axis name, a tuple of names, or None
    (replicated).  A tuple, so it compares equal to ``tuple(P(...))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def make_rules(mode: str = "train", multi_pod: bool = False) -> Rules:
    """Sharding rules for 'train' | 'prefill' | 'decode' (one table:
    decode keeps the training layout's FSDP storage)."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "embed": "data",  # FSDP shard dim of stored weights
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": None,
        "kv_lora": None,
        "qk_dim": None,
        "v_dim": None,
        "state": None,
        "conv_dim": "model",
        "ssm_heads": "model",
        "head_dim": None,
        "layers": None,
        "norm": None,
        "seq": None,
        "seq_model": "model",  # Megatron-SP residual sharding
        "kv_seq": "model",
        "frames": None,
    }


def make_serving_rules(multi_pod: bool = False) -> Rules:
    """Rules of the holographic serving path: the pooled arena's ΣO rows
    over ``model`` (each device holds whole tenants, so the grouped MAC
    and the readout stay shard-local) and the stream rows over ``data``
    (each row's forward FFT runs on one data shard)."""
    stream = ("pod", "data") if multi_pod else ("data",)
    return {
        "grating": "model",
        "stream_batch": stream,
        "channels": None,
        "freq": None,
    }


def _axis_size(mesh, mesh_axes) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    n = 1
    for a in mesh_axes:
        n *= mesh.shape[a]
    return n


def spec_for(
    shape: Sequence[int],
    logical_axes: Sequence[str | None],
    rules: Rules,
    mesh,
) -> PartitionSpec:
    """Resolve logical axes to a :class:`PartitionSpec`, keeping only mesh
    axes that exist, are not yet used by an earlier dim, and divide the
    dim."""
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, logical_axes):
        mesh_axes = rules.get(name) if name else None
        if mesh_axes is None:
            parts.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        kept = []
        size = 1
        for a in mesh_axes:
            if a in mesh.shape and a not in used and dim % (size * mesh.shape[a]) == 0:
                kept.append(a)
                size *= mesh.shape[a]
        if not kept:
            parts.append(None)
        elif len(kept) == 1:
            parts.append(kept[0])
            used.update(kept)
        else:
            parts.append(tuple(kept))
            used.update(kept)
    return PartitionSpec(*parts)


def is_axes_leaf(x) -> bool:
    """Logical-axes annotations are tuples of str/None — tree *leaves*."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_specs(params: PyTree, axes_tree: PyTree, rules: Rules, mesh) -> PyTree:
    """PartitionSpec tree for a params tree (dicts, lists and tuples of
    arrays or tensors) and its parallel logical-axes tree; the axes tree
    leads the walk, since its tuple leaves are containers to a tree
    map."""
    if is_axes_leaf(axes_tree):
        shape = tuple(getattr(params, "shape", ()))
        return spec_for(shape, axes_tree, rules, mesh)
    if isinstance(axes_tree, dict):
        return {k: tree_specs(params[k], v, rules, mesh) for k, v in axes_tree.items()}
    return type(axes_tree)(
        tree_specs(p, a, rules, mesh) for p, a in zip(params, axes_tree)
    )


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` laid over a ``LocalMesh``: each dim named
    by a mesh axis (or a tuple of them) is cut evenly over that axis, in
    row-major mesh order (the first axis of a tuple most major); a dim
    named ``None`` is replicated.  Mesh positions are ``(di, mi)``, the
    grid position of ``mesh.device(di, mi)`` (``mesh.coords`` gives its
    coordinates by axis: ``(data, model)``, or ``(pod, data, model)`` on
    a multi-pod mesh)."""

    mesh: LocalMesh
    spec: PartitionSpec

    def __post_init__(self):
        names = [a for part in self.spec if part is not None
                 for a in ((part,) if isinstance(part, str) else part)]
        unknown = [a for a in names if a not in self.mesh.shape]
        if unknown or len(set(names)) != len(names):
            raise ValueError(
                f"{self.spec!r} must name each axis of the mesh {self.mesh.shape} at most once"
            )

    def positions(self) -> list[tuple[int, int]]:
        """Every mesh position, row-major."""
        d, m = self.mesh.data_ranks, self.mesh.shape["model"]
        return [(di, mi) for di in range(d) for mi in range(m)]

    def index(self, shape: Sequence[int], di: int, mi: int) -> tuple[slice, ...]:
        """The slice of a ``shape`` tensor that position ``(di, mi)`` holds
        (the reference's ``devices_indices_map`` entry for its device);
        raises where a mesh axis does not divide its dim (nothing pads)."""
        if len(shape) != len(self.spec):
            raise ValueError(f"{self.spec!r} has {len(self.spec)} dims, the tensor {tuple(shape)}")
        coord = self.mesh.coords(di, mi)
        out = []
        for dim, part in zip(shape, self.spec):
            n, c = 1, 0
            for a in () if part is None else (part,) if isinstance(part, str) else part:
                n, c = n * self.mesh.shape[a], c * self.mesh.shape[a] + coord[a]
            if dim % n:
                raise ValueError(f"{part!r} ({n} shards) does not divide a dim of {dim}")
            # a dim on no axis, or on axes of size 1, is whole: slice(None)
            out.append(slice(None) if n == 1 else slice(c * (dim // n), (c + 1) * (dim // n)))
        return tuple(out)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(len(range(*s.indices(n))) for s, n in zip(self.index(shape, 0, 0), shape))


def tree_shardings(params: PyTree, axes_tree: PyTree, rules: Rules, mesh) -> PyTree:
    """:func:`tree_specs` with each spec laid over ``mesh`` as a
    :class:`NamedSharding`."""

    def lay(specs):
        if isinstance(specs, PartitionSpec):
            return NamedSharding(mesh, specs)
        if isinstance(specs, dict):
            return {k: lay(v) for k, v in specs.items()}
        return type(specs)(lay(v) for v in specs)

    return lay(tree_specs(params, axes_tree, rules, mesh))


class ShardedTensor:
    """A tensor held as its shards on a mesh: one contiguous tensor per
    mesh position ``(di, mi)`` on ``mesh.device(di, mi)``, holding
    ``sharding.index(shape, di, mi)`` of the full tensor.  Positions that
    share a device (a logical mesh) still hold a shard each."""

    def __init__(self, shape, dtype: torch.dtype, sharding: NamedSharding, shards: dict):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self._shards = dict(shards)

    @classmethod
    def from_full(cls, tensor: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
        """Cut ``tensor`` by ``sharding``: each position's slice copied into
        a fresh tensor on its device."""
        shard_shape = sharding.shard_shape(tensor.shape)
        shards = {}
        for pos in sharding.positions():
            shard = torch.empty(shard_shape, dtype=tensor.dtype, device=sharding.mesh.device(*pos))
            shards[pos] = shard.copy_(tensor[sharding.index(tensor.shape, *pos)])
        return cls(tensor.shape, tensor.dtype, sharding, shards)

    def shard(self, di: int, mi: int) -> torch.Tensor:
        return self._shards[(di, mi)]

    def distinct(self) -> list[tuple[tuple[int, int], torch.Tensor]]:
        """``(position, shard)`` of the first position holding each region
        of the tensor, row-major: every element once, replicas skipped."""
        seen, out = set(), []
        for pos, shard in self._shards.items():
            key = tuple((s.start, s.stop) for s in self.index(*pos))
            if key not in seen:
                seen.add(key)
                out.append((pos, shard))
        return out

    def index(self, di: int, mi: int) -> tuple[slice, ...]:
        return self.sharding.index(self.shape, di, mi)

    @property
    def nbytes(self) -> int:
        """The bytes the shards hold, replicas included."""
        return sum(s.numel() * s.element_size() for s in self._shards.values())

    def full(self, device=None, out: torch.Tensor | None = None) -> torch.Tensor:
        """The whole tensor on ``device``, each region copied from the
        first position that holds it; with ``out`` (a tensor of this
        shape), written into it in place instead."""
        if out is None:
            out = torch.empty(self.shape, dtype=self.dtype, device=device)
        elif tuple(out.shape) != tuple(self.shape):
            raise ValueError(f"out of shape {tuple(out.shape)} for a tensor of {tuple(self.shape)}")
        with torch.no_grad():
            for pos, shard in self.distinct():
                out[self.index(*pos)].copy_(shard)
        return out


# ---------------------------------------------------------------------------
# collectives of the training executor (plain tensor code: on a logical
# mesh every position is one device, and the "wire" is a copy)
# ---------------------------------------------------------------------------


def all_gather(params: dict[str, ShardedTensor], modules: dict) -> None:
    """FSDP all-gather: write each parameter's whole tensor into the
    parameter of that name of every compute module (``modules`` maps a
    device to the module on it: one per distinct device of the mesh)."""
    for module in modules.values():
        named = dict(module.named_parameters())
        for name, held in params.items():
            held.full(out=named[name])


def _mean_of(per_rank: Sequence[torch.Tensor], idx: tuple, device) -> torch.Tensor:
    """The float32 mean of ``per_rank[r][idx]`` over the ranks, summed in
    rank order on ``device``."""
    first = per_rank[0][idx]
    acc = torch.empty(first.shape, dtype=torch.float32, device=device).copy_(first)
    for g in per_rank[1:]:
        acc += g[idx].to(device=device, dtype=torch.float32)
    return acc.div_(len(per_rank))


def reduce_scatter(per_rank: Sequence[torch.Tensor], sharding: NamedSharding) -> ShardedTensor:
    """The data ranks' tensors (one per rank, the same shape) reduced to
    their float32 mean, summed in rank order, and cut by ``sharding``:
    each position computes its own tile on its device, so every tile is
    elementwise the same as cutting the whole mean."""
    shape = per_rank[0].shape
    shards = {
        pos: _mean_of(per_rank, sharding.index(shape, *pos), sharding.mesh.device(*pos))
        for pos in sharding.positions()
    }
    return ShardedTensor(shape, torch.float32, sharding, shards)


# ---------------------------------------------------------------------------
# activation constraints (models call ``constrain`` with logical axes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Active:
    mesh: Any = None
    rules: Rules | None = None
    recorder: list | None = None


_state = threading.local()


def _active() -> _Active:
    if not hasattr(_state, "v"):
        _state.v = _Active()
    return _state.v


@contextlib.contextmanager
def activate(mesh, rules: Rules) -> Iterator[None]:
    """Turn on :func:`constrain` in this thread over ``mesh`` and
    ``rules``; the mesh and rules active before are restored on exit."""
    st = _active()
    prev = st.mesh, st.rules
    st.mesh, st.rules = mesh, rules
    try:
        yield
    finally:
        st.mesh, st.rules = prev


@contextlib.contextmanager
def record_constraints() -> Iterator[list]:
    """Collect, in this thread, one ``(shape, dtype, logical axes, spec)``
    tuple per :func:`constrain` call made inside ``activate()``; yields
    the list they are appended to.  A remat layer's backward recomputes
    its forward and records its sites again, so one forward's sites are
    those recorded before the backward runs."""
    st = _active()
    prev, st.recorder = st.recorder, []
    try:
        yield st.recorder
    finally:
        st.recorder = prev


def constrain(x: torch.Tensor, logical_axes: Sequence[str | None]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes: ``x``
    itself, always.  Inside :func:`activate` the spec is resolved by
    :func:`spec_for`, checked against the mesh (a ``NamedSharding``) and
    handed to the open recorder, if any; outside it nothing happens."""
    st = _active()
    if st.mesh is None or st.rules is None:
        return x
    axes = tuple(logical_axes)
    spec = spec_for(tuple(x.shape), axes, st.rules, st.mesh)
    NamedSharding(st.mesh, spec)
    if st.recorder is not None:
        st.recorder.append((tuple(x.shape), x.dtype, axes, spec))
    return x
