"""Device meshes for sharded serving (port of ``repro.launch.mesh``).

A :class:`LocalMesh` is a ``(data, model)`` grid of ``torch.device``s in
one process.  A device may appear more than once: such a *logical* mesh
runs its shards one after another on the one device, which is how the
CPU tests run an 8-device mesh (``devices=("cpu",) * 8``, the
counterpart of the reference's forced host devices) and how one card
runs (2, 2) or (1, 4) (``devices=("cuda:0",) * 4``).

Everything is a function: importing this module touches no CUDA state.

  single pod : (data=16, model=16)            — 256 cards
  multi-pod  : (pod=2, data=16, model=16)     — 512 cards across 2 pods,
               laid out as (data=32, model=16)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A ``(data, model)`` grid of devices: ``devices[di][mi]`` holds the
    ``di``-th stream-row shard and the ``mi``-th arena tile."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def device(self, di: int, mi: int) -> torch.device:
        return self.devices[di][mi]


def _visible_cuda() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def _grid(devices: Sequence[torch.device], data: int, model: int) -> LocalMesh:
    return LocalMesh(
        tuple(tuple(devices[di * model + mi] for mi in range(model)) for di in range(data))
    )


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    """The production layout over the first 256 (512) visible CUDA
    devices, raising when fewer are visible: (data=16, model=16), and
    for ``multi_pod`` the reference's (pod=2, data=16, model=16) with the
    pod axis folded into data — (32, 16) — since pods only add data
    parallelism and the model axis never crosses a pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = 1
    for s in shape:
        n *= s
    devices = _visible_cuda()
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {len(devices)} CUDA devices"
        )
    return _grid(devices[:n], n // shape[-1], shape[-1])


def make_local_mesh(
    data: int = 1, model: int = 1, *, devices: Sequence[str | torch.device] | None = None
) -> LocalMesh:
    """A ``(data, model)`` mesh.  ``devices=None`` takes the first
    ``data * model`` visible CUDA devices and raises when fewer are
    visible; an explicit sequence must hold exactly ``data * model``
    entries, row-major over (data, model), and may repeat a device."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got (data={data}, model={model})")
    n = data * model
    if devices is None:
        found = _visible_cuda()
        if len(found) < n:
            raise RuntimeError(
                f"mesh (data={data}, model={model}) needs {n} devices, found "
                f"{len(found)} CUDA devices — pass devices=(...) to lay a "
                "logical mesh over fewer (a device may repeat)"
            )
        return _grid(found[:n], data, model)
    devs = [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(
            f"mesh (data={data}, model={model}) needs exactly {n} devices, got {len(devs)}"
        )
    return _grid(devs, data, model)
