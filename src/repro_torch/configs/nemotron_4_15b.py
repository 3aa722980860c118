"""nemotron-4-15b — NVIDIA Nemotron-4 15B: GQA kv=8, squared-ReLU MLP.
(port of ``repro.configs.nemotron_4_15b``)

[arXiv:2402.16819; unverified] 32L, d_model 6144, 48 heads (kv 8),
d_ff 24576, vocab 256000.
"""

import torch

from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="nemotron-4-15b",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=24576,
        vocab=256000,
        mlp="squared_relu",
        rope_theta=10000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="nemotron-4-15b-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=384,
        vocab=512,
        mlp="squared_relu",
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
