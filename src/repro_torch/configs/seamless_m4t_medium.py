"""SeamlessM4T-medium transformer backbone [arXiv:2308.11596].

Encoder-decoder; the conformer speech frontend (mel-spectrogram + conv
feature extractor) is a stub — ``input_specs`` supplies precomputed frame
embeddings (B, frames, d_model).  12 encoder + 12 decoder layers, MHA
(GQA with kv == heads).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    mlp_type="gelu",
    frontend="audio",
    frontend_len=512,         # encoder frames after the (stubbed) conv codec
    attention_window=16384,
    source="arXiv:2308.11596 (SeamlessM4T)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="seamless-smoke",
        num_layers=2,
        encoder_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        frontend_len=32,
    )
