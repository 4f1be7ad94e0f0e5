"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

PyTorch counterpart of the JAX package's ``models/ssm.py``, function for
function.  Training/prefill uses the chunked SSD algorithm: within a chunk
of Q tokens the recurrence is materialised as a masked (Q x Q) product (the
"attention-like" dual form); across chunks the (H, P, N) states follow a
linear recurrence, a Python loop over the chunks here where the reference
runs ``lax.scan``.  Decode is the pure recurrence: an O(1) state update per
token.

Shapes: d_inner = expand*d_model, H = d_inner/head_dim heads, state N,
single B/C group (G=1).  A short depthwise conv (width 4) precedes the SSM
on the x/B/C channels.  B, C, dt, the decay and the state are f32, the rest
in the input's dtype, as in the reference; its sharding hints
(``constrain``) have no counterpart on one card and are dropped.

The reference's intra-chunk product is one four-operand einsum
``bcij,bcijh,bcjh,bcjhp->bcihp``; contracted as written it would build a
(B, NC, Q, Q, H, P) product (21 GB for zamba2 at S 8192).  Here it is
contracted pairwise with the same factors: the (B, NC, Q, Q, H) weights
``scores * decay * dt`` first, then one batched product over j with x.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """Random params on ``gen``'s device, in the reference's layouts."""
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    dev = gen.device
    conv_w = torch.empty((cfg.ssm_conv_width, conv_ch), dtype=torch.float32, device=dev)
    return {
        # fused input projection -> [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": dense_init(gen, d, 2 * di + 2 * n + h, dtype),
        "conv_w": conv_w.normal_(0.0, 1.0, generator=gen).mul_(0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        # A = -exp(a_log)
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full((h,), 0.01, dtype=torch.float32, device=dev))),
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + n]
    c = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, x, b, c, dt


def _conv(p: Dict, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over seq: xbc (B, S, CH); SiLU in f32."""
    w = p["conv_w"]  # (W, CH)
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    return F.silu((out + p["conv_b"]).float()).to(xbc.dtype)


def mamba2_forward(p: Dict, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """u: (B, S, D) -> (B, S, D).  S must be a multiple of ssm_chunk (the
    reference asserts it; this raises, and pads nothing)."""
    bsz, s, _ = u.shape
    di, n, h, pd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q = cfg.ssm_chunk
    if s % q:
        raise ValueError(f"mamba2_forward: seq {s} not a multiple of ssm_chunk {q}")
    nc = s // q

    z, x, b, c, dt = _split_proj(cfg, u @ p["in_proj"])
    xbc = _conv(p, torch.cat([x, b, c], dim=-1))
    x, b, c = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    x = x.reshape(bsz, nc, q, h, pd)
    b = b.reshape(bsz, nc, q, n).float()
    c = c.reshape(bsz, nc, q, n).float()
    dt = F.softplus(dt.float() + p["dt_bias"]).reshape(bsz, nc, q, h)
    a = -torch.exp(p["a_log"])  # (H,)

    da = dt * a  # (B, NC, Q, H), negative
    cum = torch.cumsum(da, dim=2)  # inclusive cumsum over chunk positions

    xf = x.float()
    # ---- intra-chunk (dual / attention-like form) ----------------------- #
    scores = torch.einsum("bcin,bcjn->bcij", c, b)  # (B, NC, Q, Q)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # exp(cum_i - cum_j)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=u.device))
    decay = torch.where(tri[None, None, :, :, None], decay, 0.0)
    weights = scores[..., None] * decay * dt[:, :, None, :, :]  # (B, NC, Q, Q, H)
    del decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", weights, xf)
    del weights

    # ---- chunk states and inter-chunk recurrence ------------------------- #
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, NC, Q, H)
    chunk_state = torch.einsum(
        "bcjhp,bcjn->bchpn", xf * (decay_to_end * dt)[..., None], b
    )  # (B, NC, H, P, N)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, NC, H)

    state = torch.zeros((bsz, h, pd, n), dtype=torch.float32, device=u.device)
    states_in = []  # the state ENTERING each chunk
    for ci in range(nc):
        states_in.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + chunk_state[:, ci]
    states_in = torch.stack(states_in, dim=1)  # (B, NC, H, P, N)

    y_inter = torch.einsum("bcin,bchpn->bcihp", c, states_in) * torch.exp(cum)[..., None]

    y = y_intra + y_inter + p["d_skip"][None, None, None, :, None] * xf
    y = y.reshape(bsz, s, di).to(u.dtype)

    # gated RMSNorm then output projection (mamba2 ordering)
    y = y * F.silu(z.float()).to(u.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


# --------------------------------------------------------------------------- #
# Decode (recurrent form)
# --------------------------------------------------------------------------- #
def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * n), dtype=dtype, device=device),
    }


def mamba2_decode_step(
    p: Dict, cfg: ModelConfig, u: torch.Tensor, cache: Dict, pos
) -> Tuple[torch.Tensor, Dict]:
    """u: (B, 1, D); O(1) per-token state update.  As the attention caches
    are, ``cache`` is updated in place (its ``state`` and ``conv`` tensors
    overwritten) and returned.  ``pos`` is unused, as in the reference."""
    bsz = u.shape[0]
    di, n, h, pd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    z, x, b, c, dt = _split_proj(cfg, (u @ p["in_proj"])[:, 0])
    xbc_new = torch.cat([x, b, c], dim=-1)  # (B, CH)

    # conv ring: window = [conv_cache, new]
    window = torch.cat([cache["conv"], xbc_new[:, None, :]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(conv_out.float())
    x = xbc[:, :di].reshape(bsz, h, pd)
    b = xbc[:, di:di + n]
    c = xbc[:, di + n:]

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a)  # (B, H)

    state = cache["state"] * da[:, :, None, None] + torch.einsum("bh,bn,bhp->bhpn", dt, b, x)
    y = torch.einsum("bn,bhpn->bhp", c, state) + p["d_skip"][None, :, None] * x
    y = y.reshape(bsz, 1, di).to(u.dtype)
    y = y * F.silu(z.float()).to(u.dtype)[:, None, :]
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    cache["state"].copy_(state)
    cache["conv"].copy_(window[:, 1:, :])
    return y @ p["out_proj"], cache
