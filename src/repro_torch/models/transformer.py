"""Decoder-only transformer: dense GQA (llama, qwen3, qwen2-vl, deepseek-67b,
nemotron), MoE (dbrx) and MLA + MoE with shared experts (deepseek-v2).

PyTorch counterpart of the attention-layer path of the JAX package's
``models/transformer.py``.  Params are plain nested dicts of tensors in the
reference's layouts, with one difference: ``params["layers"]`` is a Python
list of per-layer dicts (the reference stacks them on a leading L axis for
``lax.scan``), looped over in Python.  While autograd records (training),
each layer runs under the remat policy of ``models/scan_util.py``, as the
reference's scanned body runs under ``jax.checkpoint``; a forward-only
(serving) pass runs the layers as they are.  Caches are
``{"layers": [per-layer cache]}``.

Batch dict keys:
  tokens            (B, S) int                — always
  image_embeds      (B, P, D)                 — vlm frontend stub (prepended)
  mrope_positions   (3, B, S_total) int       — optional (vlm)

A layer holds ``"moe"`` or ``"ffn"`` and MLA or GQA attention, as in the
reference; ``forward`` returns the MoE layers' aux losses summed over the
layers.  The SSM and hybrid families are later slices of the port (ROADMAP,
queue: the SSM/hybrid/encdec families) and raise ``NotImplementedError``
here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.layers import dtype_of, embed_init, dense_init, rms_norm
from repro_torch.models.scan_util import remat


def _require_attention_layers(cfg: ModelConfig) -> None:
    if cfg.arch_type in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"repro_torch: {cfg.name} needs the SSM/hybrid layers, which are a later "
            "slice of the port (ROADMAP, queue: the SSM/hybrid/encdec families)"
        )


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def _layer_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    zeros = dict(dtype=dtype, device=gen.device)
    p = {
        "norm1": torch.zeros((cfg.d_model,), **zeros),
        "norm2": torch.zeros((cfg.d_model,), **zeros),
        "attn": (attn_lib.init_mla if cfg.use_mla else attn_lib.init_gqa)(gen, cfg, dtype),
    }
    if cfg.num_experts:
        p["moe"] = mlp_lib.init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = mlp_lib.init_ffn(gen, cfg, cfg.d_ff, dtype)
    return p


def init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random params on ``gen``'s device (a seeded ``torch.Generator``)."""
    _require_attention_layers(cfg)
    dtype = dtype_of(cfg.dtype)
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
        "layers": [_layer_init(gen, cfg, dtype) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return params


# --------------------------------------------------------------------------- #
# Layer body
# --------------------------------------------------------------------------- #
def _attn_layer(p, cfg: ModelConfig, x, positions, mrope_positions):
    """(the layer's output, its aux loss: the MoE's, else None)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    attend = attn_lib.mla_forward if cfg.use_mla else attn_lib.gqa_forward
    x = x + attend(p["attn"], cfg, h, positions, mrope_positions)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if "moe" in p:
        f, aux = mlp_lib.moe_ffn(p["moe"], cfg, h)
        return x + f, aux
    return x + mlp_lib.ffn(p["ffn"], cfg, h), None


def _head(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


# --------------------------------------------------------------------------- #
# Forward (full sequence)
# --------------------------------------------------------------------------- #
def embed_inputs(
    params, cfg: ModelConfig, batch
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    if cfg.frontend == "vision" and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    mrope_positions = batch.get("mrope_positions")
    if cfg.mrope and mrope_positions is None:
        mrope_positions = positions[None].expand(3, b, s)
    return x, positions, mrope_positions


def forward(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S_total, V), aux_loss scalar)."""
    _require_attention_layers(cfg)
    x, positions, mrope_positions = embed_inputs(params, cfg, batch)
    auxes = []
    for layer_p in params["layers"]:
        if _records(x, layer_p):
            x, aux = remat(_attn_layer, layer_p, cfg, x, positions, mrope_positions)
        else:
            x, aux = _attn_layer(layer_p, cfg, x, positions, mrope_positions)
        if aux is not None:
            auxes.append(aux)
    if not auxes:
        return _head(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, cfg, x), torch.stack(auxes).sum()


def _records(x, layer_p) -> bool:
    """Whether autograd records this layer: grad mode is on and its input
    or one of its parameters requires grad."""
    if not torch.is_grad_enabled():
        return False
    stack = [x, layer_p]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif torch.is_tensor(t) and t.requires_grad:
            return True
    return False


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int, device) -> Dict:
    """cache_len: serving context (for sliding-window archs pass the window)."""
    _require_attention_layers(cfg)
    dtype = dtype_of(cfg.dtype)
    init_layer = attn_lib.init_mla_cache if cfg.use_mla else attn_lib.init_gqa_cache
    return {"layers": [init_layer(cfg, batch_size, cache_len, dtype, device)
                       for _ in range(cfg.num_layers)]}


def decode_step(params, cfg: ModelConfig, batch, cache: Dict, pos) -> Tuple[torch.Tensor, Dict]:
    """One new token for every sequence.  batch: {"tokens": (B, 1)}.

    ``pos`` is the absolute position (cache slot = pos % cache_len for
    sliding-window ring buffers).  The cache is updated in place and
    returned."""
    _require_attention_layers(cfg)
    x = params["embed"][batch["tokens"]]  # (B, 1, D)
    step = attn_lib.mla_decode_step if cfg.use_mla else attn_lib.gqa_decode_step
    for layer_p, layer_c in zip(params["layers"], cache["layers"]):
        h = rms_norm(x, layer_p["norm1"], cfg.norm_eps)
        a, _ = step(layer_p["attn"], cfg, h, layer_c, pos)
        x = x + a
        h = rms_norm(x, layer_p["norm2"], cfg.norm_eps)
        if "moe" in layer_p:
            x = x + mlp_lib.moe_ffn(layer_p["moe"], cfg, h)[0]
        else:
            x = x + mlp_lib.ffn(layer_p["ffn"], cfg, h)
    return _head(params, cfg, x), cache
