"""qwen2-1.5b — Qwen2 1.5B: GQA kv=2, QKV bias, tied embeddings.
(port of ``repro.configs.qwen2_1_5b``)

[arXiv:2407.10671; hf] 28L, d_model 1536, 12 heads (kv 2, head dim
128), d_ff 8960, vocab 151936, RoPE theta 1e6, bf16 parameters and
compute.
"""

import torch

from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        mlp="swiglu",
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1000000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b-smoke",
        n_layers=2,
        d_model=96,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        mlp="swiglu",
        qkv_bias=True,
        tie_embeddings=True,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
