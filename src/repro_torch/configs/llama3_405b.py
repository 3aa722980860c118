"""llama3-405b — Llama 3.1 405B: GQA kv=8, 128k vocab.
(port of ``repro.configs.llama3_405b``)

[arXiv:2407.21783; unverified] 126L, d_model 16384, 128 heads (kv 8),
d_ff 53248, vocab 128256.
"""

import torch

from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="llama3-405b",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab=128256,
        mlp="swiglu",
        rope_theta=500000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama3-405b-smoke",
        n_layers=3,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=416,
        vocab=512,
        mlp="swiglu",
        rope_theta=500000.0,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
