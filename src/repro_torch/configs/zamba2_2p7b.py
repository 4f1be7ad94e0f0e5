"""Zamba2-2.7B [arXiv:2411.15242]: Mamba2 backbone + SHARED attention block.

54 Mamba2 (SSD) layers; one weight-shared attention+MLP block is applied
every ``hybrid_attn_every`` SSM layers, consuming concat(hidden, original
embedding) — the Zamba trick for global context at tiny parameter cost.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    hybrid_attn_every=9,  # 6 shared-block applications over 54 layers
    mlp_type="gelu",
    source="arXiv:2411.15242 (Zamba2)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="zamba2-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        ssm_state=32,
        ssm_head_dim=64,
        ssm_chunk=32,
        hybrid_attn_every=1,
        vocab_size=512,
    )
