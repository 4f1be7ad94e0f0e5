"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA with squared-ReLU MLP."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    mlp_type="squared_relu",
    rope_theta=1.0e4,
    attention_window=16384,
    source="arXiv:2402.16819 (Nemotron-4)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="nemotron-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
