"""Mamba2-780m [arXiv:2405.21060]: attention-free SSD state-space model."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="mamba2-smoke",
        num_layers=2,
        d_model=256,
        ssm_state=32,
        ssm_head_dim=64,
        ssm_chunk=32,
        vocab_size=512,
    )
