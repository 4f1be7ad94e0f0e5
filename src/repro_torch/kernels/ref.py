"""Torch-eager oracles for the port's kernels (mirrors the JAX package's
``kernels/ref.py``).

These state the semantics the kernels must reproduce, written as directly
as the JAX oracles are; the kernels' own plain versions
(``lap_bid.lap_bid_top2_plain``, ``lap_bid.lap_bid_fused_top2_plain``,
``lap_auction.lap_auction_plain``, ``migration_cost.migration_cost_plain``,
``flash_attention.flash_attention_plain``, ``flash_decode.flash_decode_plain``)
are held against them in the tests.  Only the oracles of ported kernels
live here.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def lap_bid_top2(vals: torch.Tensor):
    """Row-wise (best value, best index, second-best value) of ``vals``
    (..., m), the benefit-minus-price matrix.  Ties go to the lowest column
    index (first occurrence, as ``torch.argmax`` / ``jnp.argmax``)."""
    best_j = torch.argmax(vals, dim=-1)
    best_v = torch.gather(vals, -1, best_j[..., None])[..., 0]
    onehot = best_j[..., None] == torch.arange(vals.shape[-1], device=vals.device)
    second_v = torch.where(onehot, NEG_INF, vals).max(dim=-1).values
    return best_v, best_j.to(torch.int32), second_v


def lap_bid_fused_top2(cost: torch.Tensor, prices=None, tb_scale=0.0):
    """Oracle for the fused-benefit bid step (``lap_bid_fused_batched``).

    ``cost``: (..., n, m) raw COST matrix; the benefit is assembled here as
    ``(tb_scale * (i+1)^2 * (j+1) - cost) - p`` with 1-based indices within
    the instance and the kernel's operation order.  ``tb_scale`` is a scalar
    or one value per instance (the leading shape of ``cost``)."""
    n, m = cost.shape[-2], cost.shape[-1]
    if prices is None:
        prices = torch.zeros(cost.shape[:-2] + (m,), dtype=cost.dtype, device=cost.device)
    gi = (torch.arange(n, dtype=cost.dtype, device=cost.device) + 1.0)[:, None]
    gj = (torch.arange(m, dtype=cost.dtype, device=cost.device) + 1.0)[None, :]
    tb = torch.as_tensor(tb_scale, dtype=cost.dtype, device=cost.device)
    tb = tb.reshape(tb.shape + (1, 1))
    vals = (tb * (gi * gi) * gj - cost) - prices[..., None, :]
    return lap_bid_top2(vals)


def lap_auction(a, prices, col_of, eps, eps_min, thr, max_iters: int, neg=NEG_INF):
    """Oracle for the whole Jacobi auction (``lap_auction``): each instance of
    the (B, n, m) benefit ``a`` on its own, one step at a time, as the JAX
    ``while_loop``'s ``cond`` / ``body`` state it (``eps`` etc. (B,) f32).
    Returns ``(col_of (B, n) int64, prices (B, m) f32, iters (B,) int32,
    eps (B,) f32)``."""
    b, n, m = a.shape
    col_out = col_of.clone().long()
    p_out = prices.clone()
    it_out = torch.zeros(b, dtype=torch.int32)
    eps_out = eps.clone()
    step = torch.tensor(0.2, dtype=torch.float32)
    for k in range(b):
        p, c, e, it = p_out[k], col_out[k], eps_out[k].clone(), 0
        while not ((c >= 0).all() and e <= thr[k]) and it < max_iters:
            if (c >= 0).all():  # phase change: keep the prices
                c[:] = -1
                e = torch.maximum(e * step, eps_min[k])
            else:
                vals = a[k] - p
                best_j = torch.argmax(vals, dim=-1)
                best_v = vals[torch.arange(n), best_j]
                others = vals.clone()
                others[torch.arange(n), best_j] = -float("inf")
                second = torch.clamp_min(others.max(dim=-1).values, neg)
                offer = p[best_j] + ((best_v - second) + e)
                new_p, new_c = p.clone(), c.clone()
                for j in range(m):
                    rows = [i for i in range(n) if c[i] < 0 and best_j[i] == j and offer[i] > -5e17]
                    if rows:
                        w = max(rows, key=lambda i: (offer[i].item(), -i))
                        new_c[new_c == j] = -1
                        new_c[w] = j
                        new_p[j] = offer[w]
                p, c = new_p, new_c
            it += 1
        p_out[k], col_out[k], eps_out[k], it_out[k] = p, c, e, it
    return col_out, p_out, it_out, eps_out


def migration_cost(slots_u, slots_v, w_u, w_v) -> torch.Tensor:
    """Algorithm-3 cost matrix.

    ``slots_u``: (U, P) int job ids (-1 empty), ``slots_v``: (V, P);
    ``w_u``/``w_v``: per-slot weights 1/(2*num_gpus) with 0 for empty slots.
    Returns (U, V):  C[u,v] = sum_a w_u[u,a]*[su[u,a] not in sv[v]]
                             + sum_b w_v[v,b]*[sv[v,b] not in su[u]].
    """
    eq = slots_u[:, None, :, None] == slots_v[None, :, None, :]  # (U,V,P,P)
    u_in_v = eq.any(dim=-1)
    v_in_u = eq.any(dim=-2)
    cost_out = (w_u[:, None, :] * ~u_in_v).sum(-1)
    cost_in = (w_v[None, :, :] * ~v_in_u).sum(-1)
    return cost_out + cost_in


def flash_decode(q, k, v, valid_len):
    """Single-query GQA attention over a cache, slots >= valid_len masked.

    q (B, H, D), k/v (B, S, KV, D).  As the reference oracle, at
    ``valid_len = 0`` every logit is -1e30 and the softmax is flat: the
    result is the uniform mean of V (the kernels give zeros; ROADMAP F6)."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    logits = logits / (d**0.5)
    mask = torch.arange(s, device=q.device)[None, None, None, :] < valid_len
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """Naive softmax attention oracle.

    q/k/v: (BH, S, D) — batch*heads flattened.  fp32 accumulation.
    """
    bh, s, d = q.shape
    if scale is None:
        scale = 1.0 / (d**0.5)
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = torch.where(mask[None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype)
