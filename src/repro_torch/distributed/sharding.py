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
tile per model shard (``GratingPool.shards``).  Nothing in the port
resolves a spec at run time yet: ``make_rules``, ``spec_for``,
``tree_specs`` and ``is_axes_leaf`` wait for LM training's sharded
parameters (ROADMAP A.7) and are held against the reference's by the
tests meanwhile.

The mesh only has to carry ``shape`` (a dict of axis sizes), so a
:class:`~repro_torch.launch.mesh.LocalMesh` and the reference's
``jax.sharding.Mesh`` resolve alike.  Placing sharded parameters
(``tree_shardings``, ``activate`` / ``constrain``) belongs to LM
training and is not here.
"""

from __future__ import annotations

from typing import Any, Sequence

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
