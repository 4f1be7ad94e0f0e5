"""Qwen3-14B [hf:Qwen/Qwen3-8B family]: dense GQA decoder with QK-norm."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1.0e6,
    mlp_type="swiglu",
    attention_window=16384,
    source="hf:Qwen/Qwen3-8B (scaled per assignment)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen3-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
