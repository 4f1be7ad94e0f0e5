"""Batched auction solver for the assignment problem, in PyTorch.

Counterpart of the JAX package's ``core/matching/auction.py``: the Jacobi
(all-unassigned-bid-simultaneously) forward auction with epsilon scaling,
exact for integer benefits with a final ``eps < 1/n``, with warm starts
(``init_prices`` / per-instance ``warm``) and a native rectangular forward
auction for ``n <= m`` instances.  See that module for the algorithm and
its optimality arguments; this one states only what differs in the port.

**The loop.**  This module computes the prologue once (``span``, the
starting ``eps``, the ``warm`` override, the phase threshold, the start
prices and assignment) and hands the whole loop to
:mod:`repro_torch.kernels.lap_auction`.  ``use_kernel=True`` runs it as the
hand-written ``lap_auction`` CUDA kernel, one launch per solve with no host
read inside (its plain version for CPU tensors, which keeps the bid
kernel's ``-1e30`` "no second column" value); ``use_kernel=False`` runs the
plain loop on any device, with ``_NEG = -1e18`` as the plain top-2 in JAX.
The two differ only on single-column instances, exactly as the JAX backends
do.  A rectangular instance is the square loop with an infinite phase
threshold: one phase at ``eps_min``.

**The plain loop writes the batch out.**  JAX runs ``jax.vmap`` over a
``lax.while_loop``; the plain loop runs while ANY instance is active and
freezes each instance exactly when the vmapped ``while_loop`` would, so
``iters`` / ``prices`` agree bit for bit.  Reading ``active.any()`` is a
device->host sync, so it checks once every :data:`SYNC_EVERY` bid rounds;
:data:`loop_syncs` counts these reads (kernel solves add none).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import NO_TIMER, resolve_device
from repro_torch.kernels.lap_auction import (  # noqa: F401  (SYNC_EVERY, loop_syncs: re-exported)
    NEG_INF,
    SYNC_EVERY,
    inverse_assignment as _inverse_assignment,
    lap_auction,
    lap_auction_plain,
    loop_syncs,
)

_NEG = -1e18

#: Instance size from which ``use_kernel=None`` picks the kernel on CUDA.
KERNEL_MIN_N = 256


class AuctionResult(NamedTuple):
    # col_of[..., i] = object assigned to person (row) i
    # row_of[..., j] = person assigned to object (column) j
    col_of: torch.Tensor
    row_of: torch.Tensor
    prices: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _eps_min_tensor(eps_min, n: int, device) -> torch.Tensor:
    if eps_min is None:
        eps_min = 1.0 / (n + 1)
    return _as_f32(eps_min, device)


def _solve(
    benefit, p0, col0, eps0, eps_min_t, thr, max_iters, use_kernel, tb=None, neg=None,
    timer=NO_TIMER,
):
    """Run the loop on (B, ...) per-instance start state: the kernel
    (``use_kernel``) or the plain loop.  ``timer``
    (``repro_torch.device.device_timer``) times the kernel's launch; the
    plain loop is not timed.  Returns ``(col_of, prices, iters, eps)``."""
    b = benefit.shape[0]

    def per_instance(x):
        return x.expand(b).contiguous()

    args = (p0.contiguous(), col0, per_instance(eps0), per_instance(eps_min_t), per_instance(thr))
    if use_kernel:
        neg = NEG_INF if neg is None else neg
        return lap_auction(benefit, *args, max_iters, tb=tb, neg=neg, timer=timer)
    return lap_auction_plain(benefit, *args, max_iters, tb=tb, neg=_NEG if neg is None else neg)


def _auction_square(
    benefit: torch.Tensor,
    eps_min,
    max_iters: int,
    use_kernel: bool,
    init_prices: Optional[torch.Tensor],
    warm: Optional[torch.Tensor],
    init_col_of: Optional[torch.Tensor] = None,
    *,
    span: Optional[torch.Tensor] = None,
    tb: Optional[torch.Tensor] = None,
    neg: Optional[float] = None,
    timer=NO_TIMER,
) -> AuctionResult:
    """The square auction on a (B, n, n) batch.  ``init_col_of`` (B, n)
    starts each instance from an explicit assignment (default: all -1); a
    warm instance whose initial assignment is complete stops with zero bid
    rounds.  The fused migrate stage passes ``span`` (B,) (the starting
    epsilon scales with its COST matrix's span, as in the JAX
    ``fused._pair_auction``), ``tb`` (B,) with a raw cost matrix as
    ``benefit`` (the fused bid assembles the benefit) and ``neg`` (the
    "no second column" value of its bid path)."""
    b, n, _ = benefit.shape
    dev = benefit.device
    eps_min_t = _eps_min_tensor(eps_min, n, dev)
    thr = eps_min_t * np.float32(1 + 1e-6)
    if span is None:
        span = torch.clamp_min(benefit.abs().amax(dim=(1, 2)), 1.0)
    eps0 = torch.maximum(span / 4.0, eps_min_t)
    if warm is not None:
        eps0 = torch.where(warm, eps_min_t, eps0)
    p0 = (
        torch.zeros((b, n), dtype=torch.float32, device=dev)
        if init_prices is None
        else _as_f32(init_prices, dev)
    )
    col0 = (
        torch.full((b, n), -1, dtype=torch.int64, device=dev)
        if init_col_of is None
        else init_col_of.to(device=dev, dtype=torch.int64)
    )
    col_of, prices, iters, eps = _solve(
        benefit, p0, col0, eps0, eps_min_t, thr, max_iters, use_kernel, tb, neg, timer
    )
    # converged = the FULL epsilon schedule completed with everyone assigned
    converged = (col_of >= 0).all(dim=1) & (eps <= thr)
    return AuctionResult(col_of, _inverse_assignment(col_of, n), prices, iters, converged)


def _auction_rect(
    benefit: torch.Tensor,
    eps_min,
    max_iters: int,
    use_kernel: bool,
    init_prices: Optional[torch.Tensor],
    neg: Optional[float] = None,
    timer=NO_TIMER,
) -> AuctionResult:
    """Native rectangular forward auction, (B, n, m) with n <= m: a single
    phase at ``eps_min`` (see the JAX module for why no scaling) — the
    square loop with an infinite phase threshold.  ``neg`` overrides the
    bid path's "no second column" value."""
    b, n, m = benefit.shape
    if n > m:
        raise ValueError(f"rect auction requires n <= m, got {tuple(benefit.shape)}")
    dev = benefit.device
    eps = _eps_min_tensor(eps_min, n, dev)
    p0 = (
        torch.zeros((b, m), dtype=torch.float32, device=dev)
        if init_prices is None
        else _as_f32(init_prices, dev)
    )
    col0 = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    thr = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    col_of, prices, iters, _ = _solve(
        benefit, p0, col0, eps, eps, thr, max_iters, use_kernel, neg=neg, timer=timer
    )
    converged = (col_of >= 0).all(dim=1)
    return AuctionResult(col_of, _inverse_assignment(col_of, m), prices, iters, converged)


def _resolve_use_kernel(use_kernel: Optional[bool], benefit: torch.Tensor) -> bool:
    if use_kernel is None:
        return benefit.is_cuda and benefit.shape[-1] >= KERNEL_MIN_N
    return bool(use_kernel)


def _batch_inputs(benefits, init_prices, warm):
    benefits = torch.as_tensor(benefits)
    dev = benefits.device
    benefits = benefits.to(torch.float32).contiguous()
    if warm is not None:
        warm = torch.as_tensor(warm, device=dev).to(torch.bool)
    elif init_prices is not None:
        warm = torch.zeros(benefits.shape[0], dtype=torch.bool, device=dev)
    return benefits, warm


def auction_lap(
    benefit,
    eps_min=None,
    max_iters: int = 20_000,
    use_kernel: Optional[bool] = None,
    init_prices=None,
    warm=False,
) -> AuctionResult:
    """Maximise ``sum_i benefit[i, col_of[i]]`` over permutations of an
    (n, n) benefit tensor; runs on the tensor's device.  Same contract as
    the JAX ``auction_lap`` (``eps_min`` defaults to ``1/(n+1)``, exact for
    integer benefits; ``warm`` runs one phase at ``eps_min``)."""
    benefit = torch.as_tensor(benefit)
    n = benefit.shape[-1]
    if tuple(benefit.shape) != (n, n):
        raise ValueError(f"benefit must be square, got {tuple(benefit.shape)}")
    dev = benefit.device
    res = _auction_square(
        benefit.to(torch.float32)[None].contiguous(),
        eps_min,
        max_iters,
        _resolve_use_kernel(use_kernel, benefit),
        None if init_prices is None else _as_f32(init_prices, dev)[None],
        torch.as_tensor(warm, device=dev).to(torch.bool).reshape(1),
    )
    return AuctionResult(*(t[0] for t in res))


def auction_lap_batched(
    benefits,
    max_iters: int = 20_000,
    eps_min=None,
    use_kernel: Optional[bool] = None,
    init_prices=None,
    warm=None,
    timer=NO_TIMER,
) -> AuctionResult:
    """The square auction over a (B, n, n) batch — the Algorithm-2 fan-out.
    Every result field has a leading batch axis; ``init_prices`` (B, n) and
    ``warm`` (B,) thread last round's price state per instance; ``timer``
    (``repro_torch.device.device_timer``) times the loop on the device."""
    benefits, warm = _batch_inputs(benefits, init_prices, warm)
    return _auction_square(
        benefits,
        eps_min,
        max_iters,
        _resolve_use_kernel(use_kernel, benefits),
        init_prices,
        warm,
        timer=timer,
    )


def auction_lap_rect_batched(
    benefits,
    max_iters: int = 20_000,
    eps_min=None,
    use_kernel: Optional[bool] = None,
    init_prices=None,
    warm=None,
    timer=NO_TIMER,
) -> AuctionResult:
    """The rectangular forward auction over (B, n, m) benefits, n <= m.
    Same warm-start and ``timer`` contract as :func:`auction_lap_batched`;
    ``init_prices`` is (B, m) and ``warm`` only matters through them."""
    benefits, _ = _batch_inputs(benefits, init_prices, warm)
    return _auction_rect(
        benefits, eps_min, max_iters, _resolve_use_kernel(use_kernel, benefits), init_prices,
        timer=timer,
    )


def _pad_value(benefit: np.ndarray, finite: np.ndarray) -> np.ndarray:
    """PER-INSTANCE benefit value for padded / forbidden cells: strictly
    below anything a real edge can contribute through an augmenting cycle
    (scales with the instance size; see the JAX module)."""
    n, m = benefit.shape[-2], benefit.shape[-1]
    size = max(n, m)
    span = np.where(finite, np.abs(benefit), 0.0).max(axis=(-2, -1))
    return -(2.0 * size * span + 1.0)


def masked_square_benefit(
    cost: np.ndarray,
    maximize: bool = False,
    row_mask: Optional[np.ndarray] = None,
    col_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Embed (possibly rectangular / masked / forbidden-edge) cost instances
    (..., n, m) into square benefit matrices; padded and forbidden cells
    get the per-instance :func:`_pad_value`, so padding never wins."""
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape[-2], cost.shape[-1]
    size = max(n, m)
    benefit = cost if maximize else -cost
    finite = np.isfinite(benefit)
    pad = _pad_value(benefit, finite)[..., None, None]  # per instance
    sq = np.broadcast_to(
        pad, (*cost.shape[:-2], size, size)
    ).astype(np.float64, copy=True)
    sq[..., :n, :m] = np.where(finite, benefit, pad)
    if row_mask is not None:
        rm = np.asarray(row_mask, bool)[..., :, None]  # (..., n, 1)
        sq[..., :n, :] = np.where(rm, sq[..., :n, :], pad)
    if col_mask is not None:
        cm = np.asarray(col_mask, bool)[..., None, :]  # (..., 1, m)
        sq[..., :, :m] = np.where(cm, sq[..., :, :m], pad)
    return sq


def masked_rect_benefit(
    cost: np.ndarray,
    maximize: bool = False,
    row_mask: Optional[np.ndarray] = None,
    col_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Rectangular counterpart of :func:`masked_square_benefit`: the same
    pad rule, shape (..., n, m) preserved."""
    cost = np.asarray(cost, dtype=np.float64)
    benefit = np.where(np.isfinite(cost), cost if maximize else -cost, 0.0)
    finite = np.isfinite(cost)
    pad = _pad_value(benefit, finite)[..., None, None]  # per instance
    out = np.where(finite, benefit, pad)
    if row_mask is not None:
        out = np.where(np.asarray(row_mask, bool)[..., :, None], out, pad)
    if col_mask is not None:
        out = np.where(np.asarray(col_mask, bool)[..., None, :], out, pad)
    return out


def auction_assignment(
    cost: np.ndarray,
    maximize: bool = False,
    row_mask: Optional[np.ndarray] = None,
    col_mask: Optional[np.ndarray] = None,
    use_kernel: Optional[bool] = None,
    device=None,
):
    """Numpy-friendly wrapper returning (row_ind, col_ind) like scipy,
    solved on ``device`` (default CUDA).  Handles rectangular instances,
    masks and non-finite (forbidden) entries via the square embedding;
    pairs landing on padded / forbidden cells are dropped."""
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    sq = masked_square_benefit(cost, maximize, row_mask, col_mask)
    dev = resolve_device(device)
    res = auction_lap(torch.from_numpy(sq.astype(np.float32)).to(dev), use_kernel=use_kernel)
    col_of = res.col_of.cpu().numpy()
    row_ind = np.arange(sq.shape[0])
    ok = (row_ind < n) & (col_of < m) & (col_of >= 0)
    if row_mask is not None:
        ok &= np.asarray(row_mask, bool)[np.minimum(row_ind, n - 1)]
    if col_mask is not None:
        ok &= np.asarray(col_mask, bool)[np.minimum(col_of, m - 1)]
    row_ind, col_ind = row_ind[ok], col_of[ok]
    real = np.isfinite(cost[row_ind, col_ind])
    return row_ind[real], col_ind[real]
