"""GQA attention (llama / qwen / dbrx / nemotron), QK-norm (qwen3), M-RoPE
(qwen2-vl), sliding-window decode and its KV cache.

PyTorch counterpart of the GQA half of the JAX package's
``models/attention.py``; MLA is a later slice of the port.  The sharding
hints (``constrain``) have no counterpart on one card and are dropped.

The scaled-dot-product core :func:`sdpa` has two branches, as in the
reference: the flash kernel (``kernels/flash_attention.py``) for a causal
self-attention over the whole sequence, and an einsum path for everything
else (decode against a cache, an offset query block).  ``REPRO_USE_FLASH=1``
forces the flash branch where it applies and ``=0`` forces the einsum path;
unset, the kernel runs exactly when the tensors are on CUDA and the head
dim has a kernel instance (``flash_attention.HEAD_DIMS``); every other case
takes the einsum path, the reference's default for every head dim (ROADMAP
D6).  An explicit ``=1`` with a head dim the kernel lacks raises there.
The flash branch routes query head ``h`` to KV head ``h // (H/KV)`` inside
the kernel instead of repeating the KV heads, and reads q/k/v in their
(B, S, heads, D) layout by strides, so the three transposes of the
reference's flash branch are gone too.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def use_flash(device: torch.device, head_dim: int) -> bool:
    """The flash branch: ``REPRO_USE_FLASH`` when set ("1" on, "0" off),
    else on exactly when the tensors are on CUDA and the kernel has an
    instance for ``head_dim``."""
    env = os.environ.get("REPRO_USE_FLASH")
    if env is not None:
        return env == "1"
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    return device.type == "cuda" and head_dim in HEAD_DIMS


# --------------------------------------------------------------------------- #
# Parameter init
# --------------------------------------------------------------------------- #
def init_gqa(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, (h, hd), dtype),
        "wk": dense_init(gen, d, (kv, hd), dtype),
        "wv": dense_init(gen, d, (kv, hd), dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
    return p


# --------------------------------------------------------------------------- #
# SDPA core (GQA-aware)
# --------------------------------------------------------------------------- #
def sdpa(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    causal: bool,
    q_offset=None,  # int or 0-d tensor: absolute pos of q[0]
    kv_valid_len=None,  # int or 0-d tensor: number of valid cache slots
) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh

    if use_flash(q.device, d) and causal and s == t and q_offset is None and kv_valid_len is None:
        from repro_torch.kernels import flash_attention

        return flash_attention.flash_attention(q, k, v, causal=True)

    qg = q.reshape(b, s, kvh, g, d)
    scale = 1.0 / (d**0.5)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    logits.mul_(scale)  # (B, KV, G, S, T); in place: at S = T = 8192 it is 8.6 GB

    if causal or kv_valid_len is not None:
        rows = torch.arange(s, device=q.device)[:, None]
        if q_offset is not None:
            rows = rows + q_offset
        cols = torch.arange(t, device=q.device)[None, :]
        ok = torch.ones((s, t), dtype=torch.bool, device=q.device) if not causal else rows >= cols
        if kv_valid_len is not None:
            ok = ok & (cols < kv_valid_len)
        logits.masked_fill_(~ok, NEG_INF)

    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    # v's head dim may differ from q/k's (MLA: qk 192, v 128)
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------- #
# GQA attention: full-sequence forward + decode step
# --------------------------------------------------------------------------- #
def _project_qkv(p, cfg: ModelConfig, x, positions, mrope_positions):
    b, s, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).view(b, s, *p["wq"].shape[1:])
    k = (x @ p["wk"].reshape(d, -1)).view(b, s, *p["wk"].shape[1:])
    v = (x @ p["wv"].reshape(d, -1)).view(b, s, *p["wv"].shape[1:])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta)
    elif cfg.num_heads > 0 and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
    causal: bool = True,
) -> torch.Tensor:
    q, k, v = _project_qkv(p, cfg, x, positions, mrope_positions)
    out = sdpa(q, k, v, causal=causal)
    return out.reshape(*x.shape[:2], -1) @ p["wo"]


def init_gqa_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device) -> Dict:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, cache_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, kv, hd), dtype=dtype, device=device),
    }


def gqa_decode_step(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D) new-token hidden
    cache: Dict,
    pos,  # int or 0-d tensor: absolute position of the new token
) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  With ``cfg.attention_window`` the cache is a ring
    buffer of window length (sub-quadratic long-context decode); otherwise
    the cache covers the full context.

    Unlike the reference, which returns new cache arrays, this writes the
    new token's K/V into ``cache`` IN PLACE (slot ``pos % cache_len``) and
    returns the same dict: no copy of a cache that may hold gigabytes."""
    b = x.shape[0]
    positions = torch.as_tensor(pos, device=x.device).expand(b, 1)
    mpos = positions[None].expand(3, b, 1) if cfg.mrope else None
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, mpos)

    cache_len = cache["k"].shape[1]
    slot = pos % cache_len  # ring-buffer slot (== pos when cache covers ctx)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    valid = torch.clamp(pos + 1, max=cache_len) if torch.is_tensor(pos) else min(pos + 1, cache_len)
    out = sdpa(q, cache["k"], cache["v"], causal=False, kv_valid_len=valid)
    return out.reshape(b, 1, -1) @ p["wo"], cache
