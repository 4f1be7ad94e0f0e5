"""GQA attention (llama / qwen / dbrx / nemotron), QK-norm (qwen3), M-RoPE
(qwen2-vl), MLA (deepseek-v2), sliding-window decode and the KV caches.

PyTorch counterpart of the JAX package's ``models/attention.py``.  The
sharding hints (``constrain``) have no counterpart on one card and are
dropped.

The scaled-dot-product core :func:`sdpa` has two branches, as in the
reference: the flash kernel (``kernels/flash_attention.py``) for a causal
self-attention over the whole sequence, and an einsum path for everything
else (decode against a cache, an offset query block).  ``REPRO_USE_FLASH=1``
forces the flash branch where it applies and ``=0`` forces the einsum path;
unset, the kernel runs exactly when the tensors are on CUDA, the head dim
has a kernel instance (``flash_attention.HEAD_DIMS``), v's head dim is
q's and autograd is not recording through q/k/v; every other case takes
the einsum path, the reference's default for every head dim (ROADMAP D6,
D8).  An explicit
``=1`` raises where the kernel cannot serve: at a head dim it lacks, and
under autograd, since the kernel has no backward (the reference's
``jax.grad`` through its Pallas kernel fails too).  The reference's two
knobs of the einsum path follow the flash branch as there:
``REPRO_ABLATE_ATTN=1`` (a shape-preserving stand-in for profiling) and
``REPRO_ATTN_DTYPE=bf16`` (probabilities and V in bf16 for the last
product).
The flash branch routes query head ``h`` to KV head ``h // (H/KV)`` inside
the kernel instead of repeating the KV heads, and reads q/k/v in their
(B, S, heads, D) layout by strides, so the three transposes of the
reference's flash branch are gone too.

MLA's queries and keys have head dim ``qk_nope_dim + qk_rope_dim`` (192 in
DeepSeek-V2) and its values ``v_head_dim`` (128).  K6 has an instance at
192 (nemotron-4's GQA head dim), but it takes q, k and v of one head dim,
so ``sdpa`` routes by v's head dim too and sends MLA to the einsum path,
which takes v's own; ``REPRO_USE_FLASH=1`` raises there, as the
reference's flash branch fails on q/k and v of different head dims
(ROADMAP F7).  MLA's
decode step is the reference's absorbed form over the latent cache, with
the whole score path in f32.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def use_flash(device: torch.device, head_dim: int, v_head_dim: int, grad: bool = False) -> bool:
    """The flash branch: ``REPRO_USE_FLASH`` when set ("1" on, "0" off),
    else on exactly when the tensors are on CUDA, the kernel has an
    instance for ``head_dim`` (q's and k's), v's head dim ``v_head_dim`` is
    the same — MLA's 192 / 128 is not (F7) — and ``grad`` (autograd records
    through the inputs) is False: the kernel has no backward, so training
    takes the einsum path, the reference's only trainable one (ROADMAP
    D8)."""
    env = os.environ.get("REPRO_USE_FLASH")
    if env is not None:
        return env == "1"
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    return device.type == "cuda" and head_dim in HEAD_DIMS and v_head_dim == head_dim and not grad


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


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """DeepSeek-V2 multi-head latent attention parameters."""
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    qn, qr, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        # queries (undecomposed, as in the reference)
        "wq": dense_init(gen, d, (h, qn + qr), dtype),
        # compressed KV latent + decoupled rope key
        "wkv_a": dense_init(gen, d, (r + qr,), dtype),
        "kv_norm": torch.zeros((r,), dtype=dtype, device=gen.device),
        # up-projection from the latent to per-head K_nope and V
        "wkv_b": dense_init(gen, r, (h, qn + vd), dtype),
        "wo": dense_init(gen, h * vd, d, dtype),
    }


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

    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if (causal and s == t and q_offset is None and kv_valid_len is None
            and use_flash(q.device, d, v.shape[-1], grad)):
        from repro_torch.kernels import flash_attention

        return flash_attention.flash_attention(q, k, v, causal=True)

    if os.environ.get("REPRO_ABLATE_ATTN") == "1":
        # profiling bisection knob: shape-preserving stand-in for SDPA
        return torch.repeat_interleave(v.mean(dim=1, keepdim=True), g, dim=2).to(q.dtype) + 0 * q

    qg = q.reshape(b, s, kvh, g, d)
    scale = 1.0 / (d**0.5)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    # (B, KV, G, S, T).  In place: at S = T = 8192 it is 8.6 GB.  Autograd
    # allows it: the einsum's backward reads its inputs, not this output, and
    # neither the scaling's nor the mask's backward reads a value; the
    # softmax saves its own output.
    logits.mul_(scale)

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
    # Perf knob of the reference: the probs tensor is the largest buffer of
    # this path, and bf16 halves its traffic (the softmax stays f32).
    if os.environ.get("REPRO_ATTN_DTYPE", "f32") == "bf16":
        out = torch.einsum("bkgst,btkd->bskgd", probs.to(torch.bfloat16), v.to(torch.bfloat16))
    else:
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


# --------------------------------------------------------------------------- #
# MLA (deepseek-v2)
# --------------------------------------------------------------------------- #
def _mla_latent(p, cfg: ModelConfig, x, positions):
    """Queries split into their no-rope and roped parts (B, S, H, qn / qr),
    the normed KV latent (B, S, r) and the roped shared key (B, S, 1, qr)."""
    b, s, d = x.shape
    qn, r = cfg.qk_nope_dim, cfg.kv_lora_rank
    q = (x @ p["wq"].reshape(d, -1)).view(b, s, *p["wq"].shape[1:])
    q_nope, q_rope = q[..., :qn], apply_rope(q[..., qn:], positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"]  # (B, S, r + qr)
    ckv = rms_norm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., None, r:], positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def mla_forward(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    mrope_positions=None,
    causal: bool = True,
) -> torch.Tensor:
    b, s, _ = x.shape
    h, qn, qr, vd, r = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    q_nope, q_rope, ckv, k_rope = _mla_latent(p, cfg, x, positions)
    kv_up = (ckv @ p["wkv_b"].reshape(r, -1)).view(b, s, h, qn + vd)
    k_nope, v = kv_up[..., :qn], kv_up[..., qn:]
    k = torch.cat([k_nope, k_rope.expand(b, s, h, qr)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(qq, k, v, causal=causal)
    return out.reshape(b, s, h * vd) @ p["wo"]


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device) -> Dict:
    """MLA's memory win: the cache holds the r-dim latent and the rope key,
    not per-head K/V: (r + qr) values per token against 2 * H * hd."""
    return {
        "ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim), dtype=dtype, device=device),
    }


def mla_decode_step(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D)
    cache: Dict,
    pos,  # int or 0-d tensor
) -> Tuple[torch.Tensor, Dict]:
    """One decode step of absorbed attention over the latent cache, written
    into ``cache`` in place (slot ``pos % cache_len``) as
    :func:`gqa_decode_step` does."""
    b = x.shape[0]
    h, qn, qr, vd = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    positions = torch.as_tensor(pos, device=x.device).expand(b, 1)
    q_nope, q_rope, ckv_new, k_rope_new = _mla_latent(p, cfg, x, positions)

    cache_len = cache["ckv"].shape[1]
    slot = pos % cache_len
    cache["ckv"][:, slot] = ckv_new[:, 0]
    cache["k_rope"][:, slot] = k_rope_new[:, 0, 0]
    valid = torch.clamp(pos + 1, max=cache_len) if torch.is_tensor(pos) else min(pos + 1, cache_len)
    ckv = cache["ckv"].float()

    # Absorbed attention: score = q_nope^T (W_b^K ckv_t) + q_rope^T k_rope_t,
    # the whole score path in f32 as in the reference (letting the absorbed
    # intermediates round to bf16 loses prefill parity there).
    wkb_k = p["wkv_b"][..., :qn].float()  # (r, H, qn)
    q_latent = torch.einsum("bshe,rhe->bshr", q_nope.float(), wkb_k)  # (B, 1, H, r)
    logits = torch.einsum("bshr,btr->bhst", q_latent, ckv)
    logits = logits + torch.einsum("bshe,bte->bhst", q_rope.float(), cache["k_rope"].float())
    logits = logits * (1.0 / ((qn + qr) ** 0.5))
    mask = torch.arange(cache_len, device=x.device)[None, None, None, :] < valid
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # out = probs @ V with V = W_b^V ckv, absorbed: the latent first
    lat = torch.einsum("bhst,btr->bshr", probs, ckv)
    out = torch.einsum("bshr,rhe->bshe", lat, p["wkv_b"][..., qn:].float())
    out = out.to(x.dtype).reshape(b, 1, h * vd)
    return out @ p["wo"], cache
