"""Public wrappers around the port's CUDA kernels.

Counterpart of the JAX package's ``kernels/ops.py``: each wrapper has the
semantics of its ``ref.py`` oracle, launches the hand-written kernel for
CUDA tensors and takes the kernel's plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import NO_TIMER
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import lap_auction as _la
from repro_torch.kernels.lap_bid import lap_bid_batched, lap_bid_fused_batched
from repro_torch.kernels.migration_cost import migration_cost

EMPTY = -1


def lap_bid(a: torch.Tensor, prices: torch.Tensor):
    """Auction bid step on a BENEFIT matrix; prices subtract in-kernel.

    Shapes: ``a`` (n, m) with ``prices`` (m,), or batched ``a`` (B, n, m)
    with ``prices`` (B, m); float32.  Returns ``(best_v, best_j, second_v)``,
    each (n,) / (B, n), ``best_j`` int32.
    """
    if a.ndim == 2:
        if prices.ndim != 1:
            raise ValueError(
                f"lap_bid: prices {tuple(prices.shape)} do not match a {tuple(a.shape)}"
            )
        bv, bj, sv = lap_bid_batched(a[None].contiguous(), prices[None].contiguous())
        return bv[0], bj[0], sv[0]
    return lap_bid_batched(a, prices)


def lap_bid_fused(cost: torch.Tensor, prices: torch.Tensor, tb_scale=0.0):
    """Fused-benefit bid step on a raw COST matrix: ``-cost`` plus the
    positional tie-break ramp ``tb_scale * (i+1)^2 * (j+1)`` is assembled
    per element inside the kernel, so no benefit tensor is ever built.
    ``tb_scale=0`` is the plain bid on ``-cost``.

    Shapes: ``cost`` (n, m) with ``prices`` (m,), or batched ``cost``
    (B, n, m) with ``prices`` (B, m); float32.  ``tb_scale`` is a scalar, or
    (B,) when batched.  Returns ``(best_v, best_j, second_v)``, each (n,) /
    (B, n), ``best_j`` int32.
    """
    if cost.ndim == 2:
        if prices.ndim != 1:
            raise ValueError(
                f"lap_bid_fused: prices {tuple(prices.shape)} do not match cost "
                f"{tuple(cost.shape)}"
            )
        bv, bj, sv = lap_bid_fused(cost[None], prices[None], tb_scale)
        return bv[0], bj[0], sv[0]
    tb = torch.as_tensor(tb_scale, dtype=torch.float32, device=cost.device)
    tb = tb.reshape(-1).expand(cost.shape[0]).contiguous()
    return lap_bid_fused_batched(cost.contiguous(), prices.contiguous(), tb)


def lap_auction(a, prices, col_of, eps, eps_min, thr, max_iters: int, tb=None, neg=_la.NEG_INF):
    """The whole Jacobi auction (``kernels/lap_auction.py`` states the loop):
    ``a`` (n, m) or (B, n, m) f32 benefit (a raw COST matrix with ``tb``),
    n <= m; start ``prices`` (m,) / (B, m), ``col_of`` (n,) / (B, n) (-1 =
    unassigned); ``eps``, ``eps_min``, ``thr`` and ``tb`` scalars or (B,).
    ``thr = inf`` is the rectangular auction's single phase.  Returns
    ``(col_of, prices, iters, eps)`` with the input's batch shape,
    ``col_of`` int64, ``iters`` int32."""
    single = a.ndim == 2
    if single:
        a, prices, col_of = a[None], prices[None], col_of[None]
    b = a.shape[0]

    def per_instance(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=a.device)
        return x.reshape(-1).expand(b).contiguous()

    out = _la.lap_auction(
        a.contiguous(), prices.contiguous(), col_of, per_instance(eps), per_instance(eps_min),
        per_instance(thr), max_iters, None if tb is None else per_instance(tb), neg,
    )
    return tuple(t[0] for t in out) if single else out


def slot_weights(slots: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Per-slot f64 weights ``weights[job]``, with EMPTY (-1) slots mapped
    to 0 explicitly (never through wrap-around indexing)."""
    slots = np.asarray(slots)
    return np.where(slots == EMPTY, 0.0, weights[np.where(slots == EMPTY, 0, slots)])


def migration_cost_matrix(
    slots_u: np.ndarray, slots_v: np.ndarray, weights: np.ndarray, device, timer=NO_TIMER
) -> torch.Tensor:
    """Algorithm-3 cost matrix on ``device``.

    ``slots_u`` / ``slots_v``: host (U, P) / (V, P) integer job ids (-1
    empty); ``weights``: host f64 lookup ``job id -> 1/(2*num_gpus)``.
    Returns the (U, V) float64 tensor on ``device`` (kernel on CUDA, plain
    version on the CPU).  ``timer`` (``repro_torch.device.device_timer``)
    times the kernel's launch.
    """
    slots_u = np.asarray(slots_u)
    slots_v = np.asarray(slots_v)
    if slots_u.ndim != 2 or slots_v.ndim != 2:
        raise ValueError(
            f"migration_cost_matrix: want (U, P) / (V, P) slots, got "
            f"{slots_u.shape} and {slots_v.shape}"
        )
    if not (np.issubdtype(slots_u.dtype, np.integer) and np.issubdtype(slots_v.dtype, np.integer)):
        raise ValueError(
            f"migration_cost_matrix: slots must be integer job ids, got "
            f"{slots_u.dtype} and {slots_v.dtype}"
        )

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)

    return migration_cost(
        dev(slots_u, np.int32),
        dev(slots_v, np.int32),
        dev(slot_weights(slots_u, weights), np.float64),
        dev(slot_weights(slots_v, weights), np.float64),
        timer=timer,
    )


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True):
    """Flash attention with the JAX package's contract: q/k/v (B, H, S, D)
    or (BH, S, D), all three of one shape (KV heads already repeated);
    returns that shape (for 4-D input a (B, H, S, D) view of the kernel's
    (B, S, H, D) output)."""
    if q.ndim not in (3, 4):
        raise ValueError(f"flash_attention: q must be (B,H,S,D) or (BH,S,D), got {tuple(q.shape)}")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"flash_attention: q/k/v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if q.ndim == 3:  # (BH, S, D) -> (BH, S, 1, D): one head per "batch" row
        return _fa.flash_attention(q[:, :, None], k[:, :, None], v[:, :, None], causal)[:, :, 0]
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal)
    return out.transpose(1, 2)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len):
    """Single-token GQA decode attention; q (B, H, D), cache k/v
    (B, S, KV, D).

    ``H`` must be a multiple of ``KV``; ``valid_len`` is ONE scalar for the
    whole batch (an int or a 0-d tensor; a (B,) array raises, as the
    reference kernel's ``broadcast_to((1, 1))`` does).  Zeros at
    ``valid_len = 0``.  Returns (B, H, D)."""
    return _fd.flash_decode(q, k, v, valid_len)
