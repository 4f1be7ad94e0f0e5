"""DeepSeek-V2-236B [arXiv:2405.04434]: MLA + fine-grained MoE.

Multi-head latent attention with kv_lora_rank=512 (the KV cache stores the
512-dim compressed latent + 64-dim decoupled RoPE key, NOT per-head K/V),
160 routed experts top-6 plus 2 shared experts, expert hidden dim 1536.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # MLA: per-head K/V reconstructed from the latent
    d_ff=1536,          # routed-expert hidden dim per assignment
    vocab_size=102400,
    head_dim=128,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    mlp_type="swiglu",
    attention_window=16384,
    source="arXiv:2405.04434 (DeepSeek-V2)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="deepseek-v2-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        qk_nope_dim=32,
        qk_rope_dim=16,
        v_head_dim=32,
        kv_lora_rank=64,
        d_ff=128,
        moe_d_ff=128,
        num_experts=4,
        num_experts_per_token=2,
        num_shared_experts=1,
        vocab_size=512,
    )
