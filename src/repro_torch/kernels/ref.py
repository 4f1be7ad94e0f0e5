"""Torch-eager oracles for the port's kernels (mirrors the JAX package's
``kernels/ref.py``).

These state the semantics the kernels must reproduce, written as directly
as the JAX oracles are; the kernels' own plain versions
(``lap_bid.lap_bid_top2_plain``, ``migration_cost.migration_cost_plain``)
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
