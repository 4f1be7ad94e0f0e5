"""Public wrappers around the port's CUDA kernels.

Counterpart of the JAX package's ``kernels/ops.py``: each wrapper has the
semantics of its ``ref.py`` oracle, launches the hand-written kernel for
CUDA tensors and takes the kernel's plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.lap_bid import lap_bid_batched
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


def slot_weights(slots: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Per-slot f64 weights ``weights[job]``, with EMPTY (-1) slots mapped
    to 0 explicitly (never through wrap-around indexing)."""
    slots = np.asarray(slots)
    return np.where(slots == EMPTY, 0.0, weights[np.where(slots == EMPTY, 0, slots)])


def migration_cost_matrix(
    slots_u: np.ndarray, slots_v: np.ndarray, weights: np.ndarray, device
) -> torch.Tensor:
    """Algorithm-3 cost matrix on ``device``.

    ``slots_u`` / ``slots_v``: host (U, P) / (V, P) integer job ids (-1
    empty); ``weights``: host f64 lookup ``job id -> 1/(2*num_gpus)``.
    Returns the (U, V) float64 tensor on ``device`` (kernel on CUDA, plain
    version on the CPU).
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
    )
