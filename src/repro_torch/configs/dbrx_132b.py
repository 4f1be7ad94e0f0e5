"""DBRX-132B [hf:databricks/dbrx-base]: fine-grained MoE, 16 experts top-4."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    num_experts=16,
    num_experts_per_token=4,
    moe_d_ff=10752,
    mlp_type="swiglu",
    rope_theta=5.0e5,
    attention_window=16384,
    source="hf:databricks/dbrx-base",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="dbrx-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        moe_d_ff=512,
        num_experts=4,
        num_experts_per_token=2,
        vocab_size=512,
    )
