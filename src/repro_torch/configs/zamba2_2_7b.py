"""zamba2-2.7b — Zamba2 2.7B: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242] (port of ``repro.configs.zamba2_2_7b``)

54 Mamba2 layers, d_model 2560, ssm_state 64 (expand 2 → d_inner 5120,
head_dim 64 → 80 SSM heads, one group); one shared attention block (32
heads, kv 32, MLP 10240) applied before every 6 layers at 2×d_model
width, head dim 2·2560/32 = 160; vocab 32000, tied embeddings, bf16.
"""

import torch

from repro_torch.models.zamba import ZambaConfig


def config() -> ZambaConfig:
    return ZambaConfig(
        name="zamba2-2.7b",
        n_layers=54,
        d_model=2560,
        d_state=64,
        d_conv=4,
        expand=2,
        ssm_head_dim=64,
        n_groups=1,
        vocab=32000,
        shared_every=6,
        attn_heads=32,
        attn_kv_heads=32,
        attn_d_ff=10240,
        tie_embeddings=True,
        d_ff=10240,
        n_heads=32,
        n_kv_heads=32,
    )


def smoke_config() -> ZambaConfig:
    return ZambaConfig(
        name="zamba2-2.7b-smoke",
        n_layers=4,
        d_model=64,
        d_state=16,
        d_conv=4,
        expand=2,
        ssm_head_dim=16,
        n_groups=1,
        vocab=512,
        shared_every=2,
        attn_heads=4,
        attn_kv_heads=4,
        attn_d_ff=128,
        tie_embeddings=True,
        d_ff=128,
        n_heads=4,
        n_kv_heads=4,
        chunk=16,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
