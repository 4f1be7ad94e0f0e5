"""Decoder-only model: dense GQA (llama, qwen3, qwen2-vl, deepseek-67b,
nemotron), MoE (dbrx), MLA + MoE with shared experts (deepseek-v2), the
Mamba-2 SSM (mamba2) and the SSM + shared-attention hybrid (zamba2).

PyTorch counterpart of the JAX package's ``models/transformer.py``.  Params
are plain nested dicts of tensors in the reference's layouts, with one
difference: ``params["layers"]`` is a Python list of per-layer dicts (the
reference stacks them on a leading L axis for ``lax.scan``), looped over in
Python.  While autograd records (training), each layer runs under the remat
policy of ``models/scan_util.py``, as the reference's scanned body runs
under ``jax.checkpoint``; a forward-only (serving) pass runs the layers as
they are.  Caches are ``{"layers": [per-layer cache]}``, plus
``"shared": [GQA cache per group]`` for the hybrid.

Batch dict keys:
  tokens            (B, S) int                — always
  image_embeds      (B, P, D)                 — vlm frontend stub (prepended)
  mrope_positions   (3, B, S_total) int       — optional (vlm)

An attention layer holds ``"moe"`` or ``"ffn"`` and MLA or GQA attention, as
in the reference; ``forward`` returns the MoE layers' aux losses summed over
the layers.  An SSM layer holds ``{"norm1", "mamba"}``.  The hybrid applies
one weight-shared attention + MLP block (``params["shared_attn"]``, fed
``concat(x, x0)`` with ``x0`` the embeddings) after every
``hybrid_attn_every`` SSM layers, then runs the ``num_layers %
hybrid_attn_every`` tail layers.  Its decode step runs that tail too, so
decode equals the forward; the reference's decode step skips it (ROADMAP
D14; no shipped config has a tail).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import dtype_of, embed_init, dense_init, rms_norm
from repro_torch.models.scan_util import remat


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def _ssm_family(cfg: ModelConfig) -> bool:
    return cfg.arch_type in ("ssm", "hybrid")


def _hybrid(cfg: ModelConfig) -> bool:
    return cfg.arch_type == "hybrid" and bool(cfg.hybrid_attn_every)


def _layer_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    zeros = dict(dtype=dtype, device=gen.device)
    if _ssm_family(cfg):
        return {"norm1": torch.zeros((cfg.d_model,), **zeros),
                "mamba": ssm_lib.init_mamba2(gen, cfg, dtype)}
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


def _shared_block_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """Zamba2's weight-shared attention+MLP block (consumes concat(x, x0))."""
    zeros = dict(dtype=dtype, device=gen.device)
    return {
        "in_proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype),
        "norm1": torch.zeros((2 * cfg.d_model,), **zeros),
        "attn": attn_lib.init_gqa(gen, cfg, dtype),
        "norm2": torch.zeros((cfg.d_model,), **zeros),
        "ffn": mlp_lib.init_ffn(gen, cfg, cfg.d_ff, dtype),
    }


def init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random params on ``gen``'s device (a seeded ``torch.Generator``)."""
    dtype = dtype_of(cfg.dtype)
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
        "layers": [_layer_init(gen, cfg, dtype) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    if _hybrid(cfg):
        params["shared_attn"] = _shared_block_init(gen, cfg, dtype)
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


def _ssm_layer(p, cfg: ModelConfig, x):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    return x + ssm_lib.mamba2_forward(p["mamba"], cfg, h)


def _shared_block(p, cfg: ModelConfig, x, x0, attend):
    """The hybrid's shared block; ``attend(attn_params, h)`` is its GQA
    attention: the full-sequence forward, or a decode step on its cache."""
    h = rms_norm(torch.cat([x, x0], dim=-1), p["norm1"], cfg.norm_eps)
    x = x + attend(p["attn"], h @ p["in_proj"])
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_lib.ffn(p["ffn"], cfg, h)


def _groups(cfg: ModelConfig):
    """The SSM stack's runs of layers, ``(start, stop)`` each, and how many
    of them (all but a tail) the hybrid's shared block follows; an SSM
    stack with no shared block is one run followed by none."""
    if not _hybrid(cfg):
        return 0, [(0, cfg.num_layers)]
    per = cfg.hybrid_attn_every
    groups = cfg.num_layers // per
    spans = [(g * per, (g + 1) * per) for g in range(groups)]
    if groups * per < cfg.num_layers:
        spans.append((groups * per, cfg.num_layers))
    return groups, spans


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
    x, positions, mrope_positions = embed_inputs(params, cfg, batch)
    if _ssm_family(cfg):
        x = _forward_ssm_stack(params, cfg, x, positions)
        return _head(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)
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


def _forward_ssm_stack(params, cfg: ModelConfig, x, positions):
    x0 = x
    groups, spans = _groups(cfg)
    for g, (a, b) in enumerate(spans):
        for layer_p in params["layers"][a:b]:
            if _records(x, layer_p):
                x = remat(_ssm_layer, layer_p, cfg, x)
            else:
                x = _ssm_layer(layer_p, cfg, x)
        if g < groups:
            x = _shared_block(params["shared_attn"], cfg, x, x0,
                              lambda a, h: attn_lib.gqa_forward(a, cfg, h, positions))
    return x


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
    dtype = dtype_of(cfg.dtype)
    if _ssm_family(cfg):
        cache = {"layers": [ssm_lib.init_mamba2_cache(cfg, batch_size, dtype, device)
                            for _ in range(cfg.num_layers)]}
        if _hybrid(cfg):
            cache["shared"] = [attn_lib.init_gqa_cache(cfg, batch_size, cache_len, dtype, device)
                               for _ in range(_groups(cfg)[0])]
        return cache
    init_layer = attn_lib.init_mla_cache if cfg.use_mla else attn_lib.init_gqa_cache
    return {"layers": [init_layer(cfg, batch_size, cache_len, dtype, device)
                       for _ in range(cfg.num_layers)]}


def decode_step(params, cfg: ModelConfig, batch, cache: Dict, pos) -> Tuple[torch.Tensor, Dict]:
    """One new token for every sequence.  batch: {"tokens": (B, 1)}.

    ``pos`` is the absolute position (cache slot = pos % cache_len for
    sliding-window ring buffers).  The cache is updated in place and
    returned."""
    x = params["embed"][batch["tokens"]]  # (B, 1, D)
    if _ssm_family(cfg):
        return _head(params, cfg, _decode_ssm_stack(params, cfg, x, cache, pos)), cache
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


def _decode_ssm_stack(params, cfg: ModelConfig, x, cache, pos):
    x0 = x
    groups, spans = _groups(cfg)
    for g, (a, b) in enumerate(spans):
        for layer_p, layer_c in zip(params["layers"][a:b], cache["layers"][a:b]):
            h = rms_norm(x, layer_p["norm1"], cfg.norm_eps)
            x = x + ssm_lib.mamba2_decode_step(layer_p["mamba"], cfg, h, layer_c, pos)[0]
        if g < groups:
            shared = cache["shared"][g]
            x = _shared_block(params["shared_attn"], cfg, x, x0,
                              lambda a, h: attn_lib.gqa_decode_step(a, cfg, h, shared, pos)[0])
    return x
