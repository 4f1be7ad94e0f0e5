"""Encoder-decoder transformer (SeamlessM4T backbone).

PyTorch counterpart of the JAX package's ``models/encdec.py``, function for
function.  Encoder: bidirectional self-attention over (stubbed) audio-frame
embeddings.  Decoder: causal self-attention + cross-attention to the
encoder output, standard teacher-forced training.

Batch dict:
  audio_frames (B, F, D)   — frontend stub output (encoder input)
  tokens       (B, S) int  — decoder input (targets shifted by caller)

Params are plain nested dicts of tensors in the reference's layouts; the
reference's stacked ``enc_layers`` and ``dec_layers`` are Python lists of
per-layer dicts here, looped over in Python, each layer under the remat
policy of ``models/scan_util.py`` while autograd records (as
``models/transformer.py`` runs its layers).

Routing: only the decoder's causal self-attention over the whole sequence
reaches the flash branch of ``attention.sdpa`` (K6); the encoder and every
cross-attention are non-causal and take the einsum path, as in the
reference, whose flash branch is causal-only too.

Decode cache: ``{"layers": [per-decoder-layer GQA cache], "cross_k",
"cross_v"}``, the cross K/V over the encoder output stacked on a leading L
axis, ``(L, B, F, KV, hd)``.  ``init_cache`` makes them zeros and
:func:`prefill_cross` computes them; the serving engine's
``greedy_generate`` never calls it, in the reference too, so served
decoding attends to zero cross K/V (ROADMAP D15).  The decode step writes
its self-attention cache in place, as every decode step of the port does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.layers import dtype_of, embed_init, dense_init, rms_norm
from repro_torch.models.scan_util import remat
from repro_torch.models.transformer import _records


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    zeros = dict(dtype=dtype, device=gen.device)
    return {
        "norm1": torch.zeros((cfg.d_model,), **zeros),
        "attn": attn_lib.init_gqa(gen, cfg, dtype),
        "norm2": torch.zeros((cfg.d_model,), **zeros),
        "ffn": mlp_lib.init_ffn(gen, cfg, cfg.d_ff, dtype),
    }


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    zeros = dict(dtype=dtype, device=gen.device)
    return {
        "norm1": torch.zeros((cfg.d_model,), **zeros),
        "self_attn": attn_lib.init_gqa(gen, cfg, dtype),
        "norm_x": torch.zeros((cfg.d_model,), **zeros),
        "cross_attn": attn_lib.init_gqa(gen, cfg, dtype),
        "norm2": torch.zeros((cfg.d_model,), **zeros),
        "ffn": mlp_lib.init_ffn(gen, cfg, cfg.d_ff, dtype),
    }


def init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random params on ``gen``'s device (a seeded ``torch.Generator``)."""
    dtype = dtype_of(cfg.dtype)
    zeros = dict(dtype=dtype, device=gen.device)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "enc_layers": [_enc_layer_init(gen, cfg, dtype) for _ in range(cfg.encoder_layers)],
        "dec_layers": [_dec_layer_init(gen, cfg, dtype) for _ in range(cfg.num_layers)],
        "enc_norm": torch.zeros((cfg.d_model,), **zeros),
        "final_norm": torch.zeros((cfg.d_model,), **zeros),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
    }


# --------------------------------------------------------------------------- #
def _run_layer(body, layer_p, cfg, x, *rest):
    """``body(layer_p, cfg, x, *rest)``, under remat while autograd records."""
    if _records(x, layer_p):
        return remat(body, layer_p, cfg, x, *rest)
    return body(layer_p, cfg, x, *rest)


def _enc_layer(p, cfg: ModelConfig, x, positions):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    y = x + attn_lib.gqa_forward(p["attn"], cfg, h, positions, causal=False)
    h = rms_norm(y, p["norm2"], cfg.norm_eps)
    return y + mlp_lib.ffn(p["ffn"], cfg, h)


def encode(params, cfg: ModelConfig, audio_frames: torch.Tensor) -> torch.Tensor:
    x = audio_frames.to(dtype_of(cfg.dtype))
    b, f = x.shape[:2]
    positions = torch.arange(f, device=x.device)[None, :].expand(b, f)
    for layer_p in params["enc_layers"]:
        x = _run_layer(_enc_layer, layer_p, cfg, x, positions)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _heads(x, w):
    """``einsum("bsd,dhe->bshe", x, w)``: a projection to (B, S, heads, hd)."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, *w.shape[1:])


def _cross_attention(p, cfg: ModelConfig, h, enc_out):
    """Cross-attention: queries from decoder, K/V from encoder output."""
    out = attn_lib.sdpa(_heads(h, p["wq"]), _heads(enc_out, p["wk"]), _heads(enc_out, p["wv"]),
                        causal=False)
    return out.reshape(*h.shape[:2], -1) @ p["wo"]


def _dec_layer(p, cfg: ModelConfig, x, positions, enc_out):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    y = x + attn_lib.gqa_forward(p["self_attn"], cfg, h, positions)
    h = rms_norm(y, p["norm_x"], cfg.norm_eps)
    y = y + _cross_attention(p["cross_attn"], cfg, h, enc_out)
    h = rms_norm(y, p["norm2"], cfg.norm_eps)
    return y + mlp_lib.ffn(p["ffn"], cfg, h)


def forward(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), a zero aux loss)."""
    enc_out = encode(params, cfg, batch["audio_frames"])
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for layer_p in params["dec_layers"]:
        x = _run_layer(_dec_layer, layer_p, cfg, x, positions, enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int, device) -> Dict:
    dtype = dtype_of(cfg.dtype)
    l, kv, hd, f = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.frontend_len
    return {
        "layers": [attn_lib.init_gqa_cache(cfg, batch_size, cache_len, dtype, device)
                   for _ in range(l)],
        # precomputed cross K/V over the encoder output (prefill artifact)
        "cross_k": torch.zeros((l, batch_size, f, kv, hd), dtype=dtype, device=device),
        "cross_v": torch.zeros((l, batch_size, f, kv, hd), dtype=dtype, device=device),
    }


def prefill_cross(params, cfg: ModelConfig, enc_out: torch.Tensor):
    """Compute per-layer cross-attention K/V once from the encoder output:
    ``(L, B, F, KV, hd)`` each, the layout of the cache's ``cross_k`` /
    ``cross_v``."""
    ks = torch.stack([_heads(enc_out, p["cross_attn"]["wk"]) for p in params["dec_layers"]])
    vs = torch.stack([_heads(enc_out, p["cross_attn"]["wv"]) for p in params["dec_layers"]])
    return ks, vs


def decode_step(params, cfg: ModelConfig, batch, cache: Dict, pos) -> Tuple[torch.Tensor, Dict]:
    """One new token for every sequence.  batch: {"tokens": (B, 1)}.  The
    self-attention caches are updated in place and the cache returned."""
    x = params["embed"][batch["tokens"]]  # (B, 1, D)
    b = x.shape[0]
    for i, (layer_p, layer_c) in enumerate(zip(params["dec_layers"], cache["layers"])):
        h = rms_norm(x, layer_p["norm1"], cfg.norm_eps)
        a, _ = attn_lib.gqa_decode_step(layer_p["self_attn"], cfg, h, layer_c, pos)
        x = x + a
        h = rms_norm(x, layer_p["norm_x"], cfg.norm_eps)
        cross = layer_p["cross_attn"]
        co = attn_lib.sdpa(_heads(h, cross["wq"]), cache["cross_k"][i], cache["cross_v"][i],
                           causal=False)
        x = x + co.reshape(b, 1, -1) @ cross["wo"]
        h = rms_norm(x, layer_p["norm2"], cfg.norm_eps)
        x = x + mlp_lib.ffn(layer_p["ffn"], cfg, h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], cache
