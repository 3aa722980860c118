"""deepseek-v2-lite-16b — DeepSeek-V2-Lite: MLA + DeepSeekMoE.
(port of ``repro.configs.deepseek_v2_lite_16b``)

[arXiv:2405.04434; hf] 27L, d_model 2048, 16 heads, MLA kv_lora 512
(qk_nope 128, qk_rope 64, v 128); MoE 64 routed experts top-6 (d_ff
1408) + 2 shared experts; first layer dense (d_ff 10944); router groups
of 2048 tokens; vocab 102400, untied head, bf16 parameters and compute.
"""

import torch

from repro_torch.models.mla import MLAConfig


def config() -> MLAConfig:
    return MLAConfig(
        name="deepseek-v2-lite-16b",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,  # first dense layer
        vocab=102400,
        kv_lora=512,
        qk_nope=128,
        qk_rope=64,
        v_dim=128,
        n_experts=64,
        top_k=6,
        moe_d_ff=1408,
        n_shared_experts=2,
        first_k_dense=1,
        router_group=2048,
        rope_theta=10000.0,
    )


def smoke_config() -> MLAConfig:
    return MLAConfig(
        name="deepseek-v2-lite-16b-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        kv_lora=32,
        qk_nope=16,
        qk_rope=8,
        v_dim=16,
        n_experts=8,
        top_k=2,
        moe_d_ff=32,
        n_shared_experts=1,
        first_k_dense=1,
        router_group=64,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
