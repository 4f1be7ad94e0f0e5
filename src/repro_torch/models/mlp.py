"""Feed-forward variants: SwiGLU, squared-ReLU and GeLU.

PyTorch counterpart of the dense half of the JAX package's
``models/mlp.py``.  The MoE layer is a later slice of the port (ROADMAP,
queue: the MoE/MLA/SSM/hybrid/encdec families); the sharding hint on the
hidden activation has no counterpart on one card and is dropped.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init


def init_ffn(gen: torch.Generator, cfg: ModelConfig, d_ff: int, dtype) -> Dict:
    d = cfg.d_model
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, d, d_ff, dtype),
            "w_up": dense_init(gen, d, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d, dtype),
        }
    return {
        "w_up": dense_init(gen, d, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d, dtype),
    }


def ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        u = x @ p["w_up"]
        if cfg.mlp_type == "squared_relu":  # nemotron-4
            r = F.relu(u.float())
            h = (r * r).to(x.dtype)
        else:  # gelu; jax.nn.gelu is the tanh approximation
            h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_down"]
