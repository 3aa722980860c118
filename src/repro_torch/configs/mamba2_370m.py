"""mamba2-370m — Mamba-2 370M: attention-free SSD. [arXiv:2405.21060]
(port of ``repro.configs.mamba2_370m``)

48L, d_model 1024, ssm_state 128, vocab 50280 (expand 2 → d_inner 2048,
head_dim 64 → 32 SSM heads, d_conv 4, 1 group), tied embeddings,
chunk 128, bf16 parameters and compute.
"""

import torch

from repro_torch.models.mamba2 import Mamba2Config


def config() -> Mamba2Config:
    return Mamba2Config(
        name="mamba2-370m",
        n_layers=48,
        d_model=1024,
        d_state=128,
        d_conv=4,
        expand=2,
        ssm_head_dim=64,
        n_groups=1,
        vocab=50280,
        tie_embeddings=True,
    )


def smoke_config() -> Mamba2Config:
    return Mamba2Config(
        name="mamba2-370m-smoke",
        n_layers=2,
        d_model=64,
        d_state=16,
        d_conv=4,
        expand=2,
        ssm_head_dim=16,
        n_groups=1,
        vocab=512,
        tie_embeddings=True,
        chunk=16,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
