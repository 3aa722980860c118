"""internvl2-2b — InternVL2 2B backbone: the InternLM2-1.8B LM.
(port of ``repro.configs.internvl2_2b``)

[arXiv:2404.16821; hf] 24L, d_model 2048, 16 heads (kv 8, head dim
128), d_ff 8192, vocab 92553, SwiGLU, RoPE theta 1e6, untied
embeddings, bf16 parameters and compute.  The InternViT frontend is a
stub: 256 precomputed patch embeddings per image ahead of the tokens.
"""

import torch

from repro_torch.models.vlm import VLMConfig


def config() -> VLMConfig:
    return VLMConfig(
        name="internvl2-2b",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92553,
        n_patches=256,
        mlp="swiglu",
        rope_theta=1000000.0,
    )


def smoke_config() -> VLMConfig:
    return VLMConfig(
        name="internvl2-2b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab=512,
        n_patches=8,
        mlp="swiglu",
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
