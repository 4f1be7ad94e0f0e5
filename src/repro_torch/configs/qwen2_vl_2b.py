"""Qwen2-VL-2B language backbone [arXiv:2409.12191].

VLM: M-RoPE (3-section temporal/height/width rotary), dynamic-resolution
vision tokens.  The ViT frontend is a stub per the brief — ``input_specs``
supplies precomputed patch embeddings of shape (B, frontend_len, d_model).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    mrope=True,
    rope_theta=1.0e6,
    mlp_type="swiglu",
    frontend="vision",
    frontend_len=256,  # patch embeddings per image
    attention_window=16384,  # sliding-window variant for long_500k decode
    source="arXiv:2409.12191 (Qwen2-VL)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen2-vl-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        frontend_len=16,
    )
