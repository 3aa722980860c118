"""whisper-tiny — OpenAI Whisper tiny backbone (encoder–decoder).
(port of ``repro.configs.whisper_tiny``)

[arXiv:2212.04356; unverified] 4L encoder + 4L decoder, d_model 384, 6
heads (head dim 64), d_ff 1536, vocab 51865, 1500 encoder frames, tied
embeddings, bf16 parameters and compute.  The conv / mel frontend is a
stub: precomputed frame embeddings.
"""

import torch

from repro_torch.models.whisper import WhisperConfig


def config() -> WhisperConfig:
    return WhisperConfig(
        name="whisper-tiny",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51865,
        n_frames=1500,
        max_target=32768 + 1,  # decode_32k shape needs positions to 32k
        tie_embeddings=True,
    )


def smoke_config() -> WhisperConfig:
    return WhisperConfig(
        name="whisper-tiny-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        n_frames=32,
        max_target=64,
        tie_embeddings=True,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
