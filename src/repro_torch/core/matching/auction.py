"""Batched auction solver for the assignment problem, in PyTorch.

Counterpart of the JAX package's ``core/matching/auction.py``: the Jacobi
(all-unassigned-bid-simultaneously) forward auction with epsilon scaling,
exact for integer benefits with a final ``eps < 1/n``, with warm starts
(``init_prices`` / per-instance ``warm``) and a native rectangular forward
auction for ``n <= m`` instances.  See that module for the algorithm and
its optimality arguments; this one states only what differs in the port.

**The batch is written out.**  JAX runs ``jax.vmap`` over a
``lax.while_loop`` whose phase change is a ``lax.cond``.  Here the batch is
the leading dimension of every state tensor, the loop runs while ANY
instance is active, and each instance's ``(prices, col_of, eps, it)`` is
updated only while its own condition holds — ``torch.where`` against the
per-instance ``active`` mask — so an instance freezes exactly when the
vmapped ``while_loop`` would freeze it, and ``iters`` / ``prices`` agree bit
for bit.  The phase ``cond`` is a per-instance ``torch.where`` between the
two branches (vmap turns it into the same select).

**Host syncs.**  Reading ``active.any()`` is a device->host sync, so the
loop checks it once every :data:`SYNC_EVERY` bid rounds; the masking makes
the extra rounds no-ops.  :data:`loop_syncs` counts these reads.

**The bid top-2.**  ``use_kernel=True`` routes it to the hand-written
``lap_bid`` CUDA kernel (its plain version for CPU tensors, which keeps the
kernel's ``-1e30`` "no second column" value); otherwise the plain
:func:`_top2` below, with ``_NEG = -1e18`` as in JAX.  The two differ only
on single-column instances, exactly as the JAX backends do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import lap_bid

_NEG = -1e18

#: Bid rounds between two reads of the host-side "any instance active" flag.
SYNC_EVERY = 8

#: Instance size from which ``use_kernel=None`` picks the kernel on CUDA.
KERNEL_MIN_N = 256

#: XLA compiles ``eps / 5.0`` (JAX ``auction.py``'s phase step) to
#: ``eps * 0.2f``, which differs from a true f32 division by one ulp on ~20%
#: of inputs; the port multiplies by the same f32 constant so phase
#: boundaries, ``iters`` and ``prices`` match the reference bit for bit.
_EPS_STEP = np.float32(0.2)


class _SyncCount:
    """Device->host reads of the loop's ``active.any()`` flag."""

    def __init__(self) -> None:
        self.count = 0


#: process-wide tally of the auction loop's host syncs (chip_smoke reads it)
loop_syncs = _SyncCount()


class AuctionResult(NamedTuple):
    # col_of[..., i] = object assigned to person (row) i
    # row_of[..., j] = person assigned to object (column) j
    col_of: torch.Tensor
    row_of: torch.Tensor
    prices: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor


def _top2(vals: torch.Tensor):
    """Row-wise (best value, best index, second-best value)."""
    best_j = torch.argmax(vals, dim=-1)
    best_v = torch.gather(vals, -1, best_j[..., None])[..., 0]
    second_v = vals.scatter(-1, best_j[..., None], _NEG).max(dim=-1).values
    return best_v, best_j, second_v


def _inverse_assignment(assign: torch.Tensor, out_size: int) -> torch.Tensor:
    """Invert partial injective maps: ``assign`` (..., k) holds values in
    ``[0, out_size)`` or -1; returns (..., out_size) with
    ``inv[..., assign[..., i]] = i`` and -1 elsewhere."""
    k = assign.shape[-1]
    safe = torch.where(assign >= 0, assign, out_size)
    inv = torch.full(
        (*assign.shape[:-1], out_size + 1), -1, dtype=assign.dtype, device=assign.device
    )
    src = torch.arange(k, dtype=assign.dtype, device=assign.device).expand_as(safe)
    return inv.scatter(-1, safe, src)[..., :out_size]


def _pick_top2(use_kernel: bool):
    """Bid top-2 as ``(benefit (B,n,m), prices (B,m)) -> (best, arg, second)``."""
    if use_kernel:
        def kernel_top2(benefit, prices):
            best_v, best_j, second_v = lap_bid(benefit, prices)
            return best_v, best_j.long(), second_v

        return kernel_top2
    return lambda benefit, prices: _top2(benefit - prices[:, None, :])


def _make_bid_round(benefit: torch.Tensor, top2):
    """Jacobi bid round over a (B, n, m) benefit batch (square or rect):
    every unassigned person bids for its best object; objects take the
    highest bid (lowest row on a tie).  Returns
    ``(prices (B,m), col_of (B,n), eps (B,)) -> (prices, col_of)``."""
    n, m = benefit.shape[-2:]
    cols = torch.arange(m, device=benefit.device)

    def bid_round(prices, col_of, eps):
        unassigned = col_of < 0
        best_v, best_j, second_v = top2(benefit, prices)
        incr = best_v - second_v + eps[:, None]
        offer = torch.gather(prices, 1, best_j) + incr
        # one-hot by comparison: F.one_hot validates its input with a sync
        bidding = unassigned[:, :, None] & (best_j[:, :, None] == cols)
        bids = torch.where(bidding, offer[:, :, None], _NEG)  # (B, n, m)
        has_bid = (bids > _NEG / 2).any(dim=1)
        winner = torch.argmax(bids, dim=1)
        new_price = bids.max(dim=1).values
        prices = torch.where(has_bid, new_price, prices)
        row_of_prev = _inverse_assignment(col_of, m)
        row_of = torch.where(has_bid, winner, row_of_prev)
        return prices, _inverse_assignment(row_of, n)

    return bid_round


def _run_loop(state, active_fn, body_fn, max_iters: int):
    """Run ``body_fn`` on the whole batch while any instance is active,
    committing each instance's new state only while ``active_fn`` holds for
    it — the per-instance freeze of a vmapped ``while_loop``.  ``state`` is
    a tuple of tensors with a leading batch axis; its last entry is the
    per-instance iteration count.  Checks the host flag every
    :data:`SYNC_EVERY` rounds."""
    done_rounds = 0
    while True:
        if done_rounds % SYNC_EVERY == 0:
            loop_syncs.count += 1
            if not bool(active_fn(state).any()):
                return state
        if done_rounds >= max_iters:
            return state
        active = active_fn(state)
        new = body_fn(state)
        state = tuple(
            torch.where(active.view(-1, *([1] * (o.ndim - 1))), nw, o)
            for nw, o in zip(new, state)
        )
        done_rounds += 1


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _eps_min_tensor(eps_min, n: int, device) -> torch.Tensor:
    if eps_min is None:
        eps_min = 1.0 / (n + 1)
    return _as_f32(eps_min, device)


def _auction_square(
    benefit: torch.Tensor,
    eps_min,
    max_iters: int,
    use_kernel: bool,
    init_prices: Optional[torch.Tensor],
    warm: Optional[torch.Tensor],
    init_col_of: Optional[torch.Tensor] = None,
    top2=None,
) -> AuctionResult:
    """The square auction on a (B, n, n) batch.  ``init_col_of`` (B, n)
    starts each instance from an explicit assignment (default: all -1); a
    warm instance whose initial assignment is complete stops with zero bid
    rounds.  ``top2`` replaces the bid top-2 of ``use_kernel``: the fused
    migrate stage passes a raw COST matrix as ``benefit`` and a top-2 that
    assembles the benefit from it (the starting epsilon then scales with
    the cost's span, as in the JAX ``fused._pair_auction``)."""
    b, n, _ = benefit.shape
    dev = benefit.device
    eps_min_t = _eps_min_tensor(eps_min, n, dev)
    thr = eps_min_t * np.float32(1 + 1e-6)
    span = torch.clamp_min(benefit.abs().amax(dim=(1, 2)), 1.0)
    eps0 = torch.maximum(span / 4.0, eps_min_t)
    if warm is not None:
        eps0 = torch.where(warm, eps_min_t, eps0)
    bid_round = _make_bid_round(benefit, top2 or _pick_top2(use_kernel))

    def active_fn(state):
        _, col_of, eps, it = state
        done = (col_of >= 0).all(dim=1) & (eps <= thr)
        return ~done & (it < max_iters)

    def body_fn(state):
        prices, col_of, eps, it = state
        all_assigned = (col_of >= 0).all(dim=1)
        phase = all_assigned & (eps > thr)
        # both branches run on the whole batch, as under vmap's cond->select
        bid_p, bid_c = bid_round(prices, col_of, eps)
        col_of = torch.where(phase[:, None], -1, bid_c)
        prices = torch.where(phase[:, None], prices, bid_p)
        eps = torch.where(phase, torch.maximum(eps * _EPS_STEP, eps_min_t), eps)
        return prices, col_of, eps, it + 1

    p0 = (
        torch.zeros((b, n), dtype=torch.float32, device=dev)
        if init_prices is None
        else _as_f32(init_prices, dev)
    )
    state = (
        p0,
        torch.full((b, n), -1, dtype=torch.int64, device=dev)
        if init_col_of is None
        else init_col_of.to(device=dev, dtype=torch.int64),
        eps0.expand(b).clone(),
        torch.zeros(b, dtype=torch.int32, device=dev),
    )
    prices, col_of, eps, iters = _run_loop(state, active_fn, body_fn, max_iters)
    # converged = the FULL epsilon schedule completed with everyone assigned
    converged = (col_of >= 0).all(dim=1) & (eps <= thr)
    return AuctionResult(col_of, _inverse_assignment(col_of, n), prices, iters, converged)


def _auction_rect(
    benefit: torch.Tensor,
    eps_min,
    max_iters: int,
    use_kernel: bool,
    init_prices: Optional[torch.Tensor],
) -> AuctionResult:
    """Native rectangular forward auction, (B, n, m) with n <= m: a single
    phase at ``eps_min`` (see the JAX module for why no scaling)."""
    b, n, m = benefit.shape
    if n > m:
        raise ValueError(f"rect auction requires n <= m, got {tuple(benefit.shape)}")
    dev = benefit.device
    eps = _eps_min_tensor(eps_min, n, dev).expand(b)
    bid_round = _make_bid_round(benefit, _pick_top2(use_kernel))

    def active_fn(state):
        _, col_of, it = state
        return ~(col_of >= 0).all(dim=1) & (it < max_iters)

    def body_fn(state):
        prices, col_of, it = state
        prices, col_of = bid_round(prices, col_of, eps)
        return prices, col_of, it + 1

    p0 = (
        torch.zeros((b, m), dtype=torch.float32, device=dev)
        if init_prices is None
        else _as_f32(init_prices, dev)
    )
    state = (
        p0,
        torch.full((b, n), -1, dtype=torch.int64, device=dev),
        torch.zeros(b, dtype=torch.int32, device=dev),
    )
    prices, col_of, iters = _run_loop(state, active_fn, body_fn, max_iters)
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
) -> AuctionResult:
    """The square auction over a (B, n, n) batch — the Algorithm-2 fan-out.
    Every result field has a leading batch axis; ``init_prices`` (B, n) and
    ``warm`` (B,) thread last round's price state per instance."""
    benefits, warm = _batch_inputs(benefits, init_prices, warm)
    return _auction_square(
        benefits,
        eps_min,
        max_iters,
        _resolve_use_kernel(use_kernel, benefits),
        init_prices,
        warm,
    )


def auction_lap_rect_batched(
    benefits,
    max_iters: int = 20_000,
    eps_min=None,
    use_kernel: Optional[bool] = None,
    init_prices=None,
    warm=None,
) -> AuctionResult:
    """The rectangular forward auction over (B, n, m) benefits, n <= m.
    Same warm-start contract as :func:`auction_lap_batched`; ``init_prices``
    is (B, m) and ``warm`` only matters through them."""
    benefits, _ = _batch_inputs(benefits, init_prices, warm)
    return _auction_rect(
        benefits, eps_min, max_iters, _resolve_use_kernel(use_kernel, benefits), init_prices
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
