"""arctic-480b — Snowflake Arctic: Dense-MoE hybrid, 128 experts top-2.
(port of ``repro.configs.arctic_480b``)

[hf:Snowflake/snowflake-arctic-base] 35L, d_model 7168, 56 heads (kv 8,
head dim 128), expert d_ff 4864, 128 experts top-2 routed **in parallel
with a dense residual FFN** of 4864, router groups of 4096 tokens, vocab
32000, bf16 parameters and compute.
"""

import torch

from repro_torch.models.moe import MoEConfig


def config() -> MoEConfig:
    return MoEConfig(
        name="arctic-480b",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,  # dense-residual branch
        vocab=32000,
        n_experts=128,
        top_k=2,
        moe_d_ff=4864,
        dense_residual=True,
        router_group=4096,
        rope_theta=10000.0,
    )


def smoke_config() -> MoEConfig:
    return MoEConfig(
        name="arctic-480b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=512,
        n_experts=8,
        top_k=2,
        moe_d_ff=96,
        dense_residual=True,
        router_group=64,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
