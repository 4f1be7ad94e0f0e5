"""Model configuration shared by all 10 assigned architectures.

One frozen dataclass covers the six architecture families (dense / MoE /
SSM / hybrid / VLM / audio enc-dec); each ``configs/<arch>.py``
instantiates it with the exact assigned numbers and provides ``reduced()``
(<= 2 layers, d_model <= 512, <= 4 experts) for the CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # -- attention ------------------------------------------------------- #
    qk_norm: bool = False           # qwen3
    rope_theta: float = 1.0e4
    mrope: bool = False             # qwen2-vl multimodal rotary
    #: sliding window (tokens) used for long-context decode on archs whose
    #: full attention would be quadratic; None = full attention.
    attention_window: Optional[int] = None

    # -- feed-forward ------------------------------------------------------ #
    mlp_type: str = "swiglu"        # swiglu | squared_relu | gelu

    # -- MoE --------------------------------------------------------------- #
    num_experts: int = 0
    num_experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim (d_ff if 0)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- MLA (deepseek-v2) -------------------------------------------------- #
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # -- SSM (mamba2 SSD) ---------------------------------------------------- #
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # -- hybrid (zamba2) ---------------------------------------------------- #
    #: apply the single SHARED attention+MLP block after every N ssm layers
    hybrid_attn_every: int = 0

    # -- encoder-decoder (seamless-m4t) -------------------------------------- #
    encoder_layers: int = 0

    # -- modality frontend stubs ---------------------------------------------- #
    frontend: Optional[str] = None  # "vision" | "audio"
    #: number of frontend embedding positions (patches / audio frames)
    frontend_len: int = 0

    # -- numerics ------------------------------------------------------------- #
    dtype: str = "bfloat16"
    norm_eps: float = 1.0e-5
    tie_embeddings: bool = False

    #: citation for the assigned config (paper / model card)
    source: str = ""

    # --------------------------------------------------------------------- #
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived sizes ------------------------------------------------------ #
    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), used for roofline
        MODEL_FLOPS = 6*N*D and for migration-overhead modelling."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        layer = 0
        hd = self.head_dim
        if self.arch_type in ("dense", "moe", "vlm", "audio"):
            if self.use_mla:
                q_dim = self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                layer += d * q_dim
                layer += d * (self.kv_lora_rank + self.qk_rope_dim)
                layer += self.kv_lora_rank * self.num_heads * (
                    self.qk_nope_dim + self.v_head_dim
                )
                layer += self.num_heads * self.v_head_dim * d
            else:
                layer += d * self.num_heads * hd          # q
                layer += 2 * d * self.num_kv_heads * hd   # k, v
                layer += self.num_heads * hd * d          # o
            layer += self._ffn_params(self.d_ff if not self.num_experts else 0)
            if self.num_experts:
                e_ff = self.moe_d_ff
                layer += d * self.num_experts  # router
                layer += self.num_experts * self._ffn_params(e_ff)
                layer += self.num_shared_experts * self._ffn_params(e_ff)
        if self.arch_type in ("ssm", "hybrid"):
            di, n = self.ssm_d_inner, self.ssm_state
            h = self.ssm_heads
            layer += d * (2 * di + 2 * n + h)  # in_proj (z, x, B, C, dt)
            layer += di * d                    # out_proj
            layer += (di + 2 * n) * self.ssm_conv_width + 2 * h  # conv + A, D
        total += self.num_layers * layer
        if self.arch_type == "hybrid" and self.hybrid_attn_every:
            # ONE shared attention+MLP block (reused)
            shared = 2 * d * self.num_heads * hd  # q, o (concat-proj folded)
            shared += 2 * d * self.num_kv_heads * hd
            shared += 2 * d * d  # concat-in projection
            shared += self._ffn_params(self.d_ff)
            total += shared
        if self.is_encoder_decoder:
            # encoder layers (self-attn + ffn) + decoder cross-attn extra
            enc_layer = 4 * d * d + self._ffn_params(self.d_ff)
            total += self.encoder_layers * enc_layer
            total += self.num_layers * (2 * d * self.num_kv_heads * hd + 2 * d * self.num_heads * hd)
        return total

    def _ffn_params(self, ff: int) -> int:
        if ff == 0:
            return 0
        if self.mlp_type == "swiglu":
            return 3 * self.d_model * ff
        return 2 * self.d_model * ff

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        all_expert = self.num_layers * self.num_experts * self._ffn_params(self.moe_d_ff)
        active_expert = self.num_layers * self.num_experts_per_token * self._ffn_params(
            self.moe_d_ff
        )
        return full - all_expert + active_expert
