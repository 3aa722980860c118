"""Fault-tolerant checkpointing (port of ``repro.checkpoint.checkpoint``).

* **Atomicity + durability** — write to ``<dir>/tmp.<step>.<pid>``,
  fsync every payload file and the manifest, then ``os.rename`` the
  directory into place and fsync the parent: a crash at any point
  mid-save never corrupts the latest good checkpoint (``latest_step``
  only ever sees complete directories).  Overwriting an existing step
  parks the old directory under a ``tmp.gc.*`` name before the rename
  (never a delete-then-rename window).  ``save(..., chaos=...)`` exposes
  the ``ckpt_write`` and ``ckpt_rename`` seams to a
  :class:`~repro_torch.distributed.fault.ChaosInjector`, so the
  crash-window claims are tested.
* **Async** — ``CheckpointManager(async_save=True)`` snapshots every
  leaf to host memory synchronously (a blocking device→host copy, so the
  writer never reads a buffer still being filled, and a copy of host
  tensors, so an in-place update after ``save`` returns cannot reach the
  file) and serializes on a writer thread; its error surfaces on
  ``wait()``.
* **Keep-K** — bounded disk usage with GC of old steps and of stale
  ``tmp.*`` directories left by crashed saves.

Format (the reference's, so a checkpoint written by either package is
read by the other): one ``.npz`` per tree ("params", "opt_state", ...)
plus ``manifest.json`` with ``step``, ``trees`` and ``extra``.  A tree is
nested dicts (keys sorted, as ``jax.tree_util`` sorts them), lists and
tuples whose leaves are tensors, numpy arrays or Python scalars; ``None``
is an empty subtree.  Leaves are keyed by their path, dict keys and list
indices joined with ``/`` (``{'w': x, 'l': [y, {'b': z}]}`` gives ``w``,
``l/0`` and ``l/1/b``).  For an ``nn.Module`` pass its ``state_dict()``.
A bfloat16 leaf, which numpy cannot hold, is written as its raw 2-byte
words (numpy dtype ``V2``), as the reference writes one, and read back
as bfloat16 wherever the template leaf is a bfloat16 tensor.

``restore`` returns host leaves shaped like the template: a CPU tensor
where the template leaf is a tensor, a numpy array otherwise; the caller
moves them to its device.  ``restore_resharded`` cuts them onto a
device mesh instead (``distributed.sharding.ShardedTensor``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import NamedSharding, ShardedTensor

PyTree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16_WORDS = np.dtype("V2")  # how a bfloat16 leaf lies in an .npz


def _leaves_with_paths(tree: PyTree, prefix: tuple = ()):
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    sequences in order, ``None`` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves_with_paths(sub, prefix + (i,))
    else:
        yield prefix, tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array the .npz holds (bfloat16 as ``V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(_BF16_WORDS)
        return t.numpy()
    return np.asarray(leaf)


def _snapshot(leaf):
    """A host copy of a leaf that no later update of the caller's buffer
    can reach: a blocking device→host copy, or a copy on the host."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _map(tree: PyTree, fn) -> PyTree:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _map(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _flatten_with_paths(tree: PyTree) -> dict[str, np.ndarray]:
    return {_key(path): _to_numpy(leaf) for path, leaf in _leaves_with_paths(tree)}


def _from_numpy(key: str, arr: np.ndarray, leaf):
    """The stored array as a leaf like ``leaf``: a CPU tensor (bfloat16
    from ``V2`` words) where the template is a tensor, else the array."""
    if not isinstance(leaf, torch.Tensor):
        return arr
    arr = np.require(arr, requirements=("C", "W"))  # keeps 0-d arrays 0-d
    if arr.dtype == _BF16_WORDS:
        if leaf.dtype != torch.bfloat16:
            raise ValueError(
                f"dtype mismatch for {key}: ckpt bfloat16 words vs model {leaf.dtype}"
            )
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten_like(template: PyTree, flat: dict[str, np.ndarray], prefix: tuple = ()) -> PyTree:
    if template is None:
        return None
    if isinstance(template, dict):
        return type(template)(
            (k, _unflatten_like(v, flat, prefix + (k,))) for k, v in template.items()
        )
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, flat, prefix + (i,)) for i, v in enumerate(template)
        )
    key = _key(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if hasattr(template, "shape") and tuple(arr.shape) != tuple(template.shape):
        raise ValueError(
            f"shape mismatch for {key}: ckpt {arr.shape} vs model {tuple(template.shape)}"
        )
    return _from_numpy(key, arr, template)


def _fsync_path(path: str) -> None:
    """fsync a file (or directory) so it survives power loss, not just
    a process crash.  Directory fsync pins the rename itself."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(
    ckpt_dir: str,
    step: int,
    trees: dict[str, PyTree],
    extra: dict | None = None,
    chaos=None,
) -> str:
    """Atomic + durable synchronous save.  trees: name → tree.

    ``extra`` is JSON-serializable metadata stored in the manifest (read
    back via :func:`read_manifest`); the replica layer keeps its tenant
    manifests there.  ``chaos`` is an optional
    :class:`~repro_torch.distributed.fault.ChaosInjector`: the
    ``ckpt_write`` seam fires once per payload file and ``ckpt_rename``
    just before the atomicity boundary."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "trees": list(trees)}
    if extra is not None:
        manifest["extra"] = extra
    for name, tree in trees.items():
        if chaos is not None:
            chaos.on("ckpt_write", payload=name)
        flat = _flatten_with_paths(tree)
        path = os.path.join(tmp, f"{name}.npz")
        np.savez(path, **flat)
        _fsync_path(path)
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)
    if chaos is not None:
        chaos.on("ckpt_rename", payload=step)
    if os.path.exists(final):
        # park the old step rather than deleting it before the rename:
        # rename is atomic, rmtree is not, so there is never a window
        # with neither the old nor the new step on disk
        trash = os.path.join(ckpt_dir, f"tmp.gc.{step}.{os.getpid()}")
        if os.path.exists(trash):
            shutil.rmtree(trash)
        os.rename(final, trash)
        os.rename(tmp, final)  # atomicity boundary
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.rename(tmp, final)  # atomicity boundary
    _fsync_path(ckpt_dir)
    return final


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """Load the manifest JSON for a step (includes ``extra`` if saved)."""
    with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, templates: dict[str, PyTree]) -> dict:
    """Restore trees of host leaves matching the given templates; raises
    ``KeyError`` on a missing leaf, ``ValueError`` on a shape mismatch."""
    base = os.path.join(ckpt_dir, f"step_{step}")
    out = {}
    for name, template in templates.items():
        with np.load(os.path.join(base, f"{name}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        out[name] = _unflatten_like(template, flat)
    return out


def _child(shardings, key):
    """``shardings[key]``, or None where ``shardings`` has no such entry."""
    try:
        return shardings[key]
    except (KeyError, IndexError, TypeError):
        return None


def _place(tree: PyTree, shardings: PyTree, where: str) -> PyTree:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)(
            (k, _place(v, _child(shardings, k), f"{where}/{k}")) for k, v in tree.items()
        )
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _place(v, _child(shardings, i), f"{where}/{i}") for i, v in enumerate(tree)
        )
    if not isinstance(shardings, NamedSharding):
        raise ValueError(
            f"leaf {where!r} needs a mesh's sharding (a NamedSharding), got "
            f"{type(shardings).__name__}"
        )
    leaf = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(tree)
    return ShardedTensor.from_full(leaf, shardings)


def restore_resharded(
    ckpt_dir: str,
    step: int,
    templates: dict[str, PyTree],
    shardings: dict[str, PyTree],
) -> dict:
    """Restore onto a device mesh (the elastic re-mesh of training state).

    ``shardings`` mirrors ``templates`` with
    :class:`~repro_torch.distributed.sharding.NamedSharding` leaves (as
    ``sharding.tree_shardings`` makes them).  Each leaf is restored to the
    host by :func:`restore`, then cut onto its mesh as a
    :class:`~repro_torch.distributed.sharding.ShardedTensor`, so a
    checkpoint of either package, written from any mesh (it holds whole
    tensors), lands on any mesh shape.  A leaf whose sharding is missing
    or is not a ``NamedSharding`` raises a ``ValueError`` naming it; a
    bfloat16 leaf needs a tensor template."""
    host = restore(ckpt_dir, step, templates)
    return {name: _place(tree, _child(shardings, name), name) for name, tree in host.items()}


class CheckpointManager:
    """Keep-K async checkpointer with restart discovery."""

    def __init__(
        self,
        ckpt_dir: str,
        keep: int = 3,
        async_save: bool = True,
        chaos=None,
    ):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self.chaos = chaos
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ----------------------------------------------------------

    def save(self, step: int, trees: dict[str, PyTree], extra: dict | None = None) -> None:
        self.wait()  # one in-flight save at a time
        # snapshot to host synchronously: the caller may update its
        # buffers in place right after this call returns
        host_trees = {name: _map(tree, _snapshot) for name, tree in trees.items()}
        if not self.async_save:
            save(self.ckpt_dir, step, host_trees, extra=extra, chaos=self.chaos)
            self._gc()
            return

        def work():
            try:
                save(self.ckpt_dir, step, host_trees, extra=extra, chaos=self.chaos)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ---------------------------------------------------------

    def restore_latest(self, templates: dict[str, PyTree]) -> tuple[int, dict] | None:
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None
        return step, restore(self.ckpt_dir, step, templates)

    # -- gc ---------------------------------------------------------------

    def _gc(self) -> None:
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(
            int(m.group(1))
            for m in (_STEP_RE.match(n) for n in os.listdir(self.ckpt_dir))
            if m
        )
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"), ignore_errors=True)
        # stale tmp.* dirs are crash debris from interrupted saves — safe
        # to reap: a live save only ever uses its own pid-suffixed name
        for name in os.listdir(self.ckpt_dir):
            if name.startswith("tmp.") and not name.endswith(f".{os.getpid()}"):
                shutil.rmtree(os.path.join(self.ckpt_dir, name), ignore_errors=True)
