"""Fault-tolerant checkpointing of the port (``checkpoint``): the
reference's on-disk format, atomicity and keep-K async manager."""

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_step,
    read_manifest,
    restore,
    restore_resharded,
    save,
)

__all__ = [
    "CheckpointManager",
    "latest_step",
    "read_manifest",
    "restore",
    "restore_resharded",
    "save",
]
