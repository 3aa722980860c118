"""granite-8b — IBM Granite 8B (code): llama-arch dense, GQA kv=8.
(port of ``repro.configs.granite_8b``)

[arXiv:2405.04324; hf] 36L, d_model 4096, 32 heads (kv 8), d_ff 14336,
vocab 49152.
"""

import torch

from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-8b",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=49152,
        mlp="swiglu",
        rope_theta=10000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-8b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        d_ff=448,
        vocab=512,
        mlp="swiglu",
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
