"""Llama-3-8B [arXiv:2407.21783]: dense GQA, 128k vocab."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    mlp_type="swiglu",
    rope_theta=5.0e5,
    attention_window=16384,
    source="arXiv:2407.21783 (Llama 3)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="llama3-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
