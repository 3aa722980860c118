"""Optimizer substrate of the port (port of ``repro.optim``): AdamW,
learning-rate schedules and error-feedback gradient compression."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.compression import (
    CompressionConfig,
    CompressionState,
    compress_gradients,
    compression_init,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = [
    "AdamWConfig",
    "CompressionConfig",
    "CompressionState",
    "adamw_init",
    "adamw_update",
    "compress_gradients",
    "compression_init",
    "cosine_schedule",
    "global_norm",
    "linear_warmup",
]
