"""DeepSeek-67B [arXiv:2401.02954]: llama-architecture dense GQA."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    mlp_type="swiglu",
    rope_theta=1.0e4,
    attention_window=16384,
    source="arXiv:2401.02954 (DeepSeek LLM)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="deepseek-67b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
