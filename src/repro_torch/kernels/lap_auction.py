"""The whole Jacobi forward auction on the card (CUDA kernel + plain).

Per instance ``b`` of a (B, n, m) benefit batch (n <= m), from a start
state ``prices`` (B, m), ``col_of`` (B, n) (-1 = unassigned), ``eps``
(B,), with ``eps_min`` (B,) and the phase threshold ``thr`` (B,)::

    while not (all assigned and eps <= thr) and iters < max_iters:
        if all assigned:            # phase change (eps > thr)
            col_of = -1; eps = max(eps * 0.2f, eps_min)
        else:                       # one Jacobi bid round
            every unassigned row i: (best, j*, second) = top-2 of a[i] - p,
                first argmax, second = max(max_{j != j*}, neg)
                offer = p[j*] + ((best - second) + eps); bids if offer > -5e17
            every column with bids: highest offer wins, lowest row on a tie;
                price = that offer; the previous owner becomes unassigned
        iters += 1

which is the ``_make_bid_round`` / ``_run_loop`` loop of the port's
``core/matching/auction.py`` (JAX ``auction.py``'s ``body`` / ``cond``)
for one instance; instances run independently.  A rectangular auction (one
phase at ``eps_min``) is the same loop with ``thr = +inf``.  ``neg`` is the
"no second column" value: -1e30 where the bid kernel's semantics hold
(``lap_bid``, the JAX Pallas kernel's NEG_INF), -1e18 where the plain
top-2's do (``_NEG``; ROADMAP D2).  ``tb`` (B,) makes ``a`` a raw COST
matrix whose benefit ``(tb * (i+1)^2) * (j+1) - cost`` is assembled in the
fused bid kernel's order.

The hand-written kernel is ``csrc/lap_auction.cu`` (its header says what
bounds it and how it is laid out): one launch per solve, no host read
inside the loop.  :func:`lap_auction` launches it for CUDA tensors and takes
:func:`lap_auction_plain`, the same loop in PyTorch, only for CPU tensors.
:func:`launch_plan` is everything the wrapper decides for a launch (regime,
cluster size, shared memory, where the benefit rows live), so it is tested
on a host without a card.

The plain loop runs on any device: the auction package calls it directly
for ``use_kernel=False`` solves.  It reads the host flag ``active.any()``
once every :data:`SYNC_EVERY` bid rounds (the masking makes the extra
rounds no-ops); :data:`loop_syncs` counts these reads.  The kernel reads
nothing back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.lap_bid import NEG_INF, fused_benefit

#: a row bids only if its offer is above this (the plain loop's ``_NEG / 2``)
BID_FLOOR = -5e17

#: Bid rounds between two reads of the plain loop's "any instance active" flag.
SYNC_EVERY = 8

#: XLA compiles ``eps / 5.0`` (JAX ``auction.py``'s phase step) to
#: ``eps * 0.2f``, which differs from a true f32 division by one ulp on ~20%
#: of inputs; the port multiplies by the same f32 constant so phase
#: boundaries, ``iters`` and ``prices`` match the reference bit for bit.
EPS_STEP = np.float32(0.2)

#: the warp regime holds an instance in one lane group: up to this many columns
WARP_MAX_M = 32
#: threads of a warp-regime block (csrc/lap_auction.cu kWarpThreads)
WARP_THREADS = 256
#: threads of a cluster-regime block (csrc/lap_auction.cu kClusterThreads)
CLUSTER_THREADS = 512
#: rows of an instance one CTA of a cluster aims to hold
ROWS_PER_CTA = 32
#: CTAs per cluster at most (16 is Hopper's non-portable maximum)
MAX_CLUSTER = 16
#: shared memory one block may use on an H100 (227 KB), less 1 KB for the
#: kernel's static counters
SMEM_LIMIT = 232_448
SMEM_BUDGET = SMEM_LIMIT - 1024
#: threads of a wide-regime block (csrc/lap_auction.cu kWideThreads)
WIDE_THREADS = 1024

_GRID_LIMIT = (1 << 31) - 1


class _SyncCount:
    """Device->host reads of the plain loop's ``active.any()`` flag."""

    def __init__(self) -> None:
        self.count = 0


#: process-wide tally of the plain auction loop's host syncs (chip_smoke reads it)
loop_syncs = _SyncCount()


class AuctionPlan(NamedTuple):
    # "warp": one lane group per instance; "cluster": a CTA cluster per
    # instance; "wide": one CTA per instance, its column state in global memory
    regime: str
    group: int  # warp regime: lanes per instance (next_pow2(m)); 0 otherwise
    cluster: int  # cluster regime: CTAs per instance; 0 otherwise
    rows_per_cta: int  # cluster / wide regime: rows of the instance each CTA holds
    threads: int  # threads per block
    grid: int  # blocks
    smem: int  # dynamic shared memory per block, bytes
    smem_rows: bool  # cluster regime: benefit rows held in shared memory (else read from L2)


def cluster_smem(m: int, rows_per_cta: int, smem_rows: bool) -> int:
    """Dynamic shared memory of one cluster-regime CTA (csrc layout): two
    (m,) u64 buffers each of partial and merged bid keys, the price and
    owner replicas, the band's ``col_of`` and bidder list, and
    (``smem_rows``) the band's rows."""
    return 40 * m + 8 * rows_per_cta + (4 * rows_per_cta * m if smem_rows else 0)


def wide_scratch(b: int, n: int, m: int) -> int:
    """Device memory the wide regime works in (csrc layout): (B, m) u64 bid
    keys, (B, m) int32 owners and (B, n) int32 bidder lists; the prices and
    the assignment are kept in the outputs."""
    return b * (12 * m + 4 * n)


def launch_plan(b: int, n: int, m: int) -> AuctionPlan:
    """How :func:`lap_auction` launches a (B, n, m) batch.

    ``m <= WARP_MAX_M``: the warp regime, ``next_pow2(m)`` lanes per
    instance, everything in registers.  Larger: the cluster regime, one
    cluster per instance of ``next_pow2(ceil(n / ROWS_PER_CTA))`` CTAs (at
    most 16), each holding a band of rows; the rows sit in shared memory
    when the band fits beside the replicated state, and are read from
    global memory (L2-resident) otherwise.  When the replicated state itself
    does not fit (m above ~5,700 columns), the wide regime: one CTA per
    instance, its per-column state in global memory."""
    if n < 1 or m < 1 or n > m:
        raise ValueError(f"lap_auction: want 1 <= n <= m, got n={n}, m={m}")
    if m <= WARP_MAX_M:
        group = 1
        while group < m:
            group *= 2
        grid = -(-b * group // WARP_THREADS)
        if grid > _GRID_LIMIT:
            raise ValueError(f"lap_auction: {b} instances exceed one launch")
        return AuctionPlan("warp", group, 0, 0, WARP_THREADS, grid, 0, False)
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * ROWS_PER_CTA < n:
        cluster *= 2
    rows = -(-n // cluster)
    smem_rows = cluster_smem(m, rows, True) <= SMEM_BUDGET
    smem = cluster_smem(m, rows, smem_rows)
    if smem > SMEM_BUDGET:
        if b > _GRID_LIMIT:
            raise ValueError(f"lap_auction: {b} instances exceed one launch")
        return AuctionPlan("wide", 0, 0, n, WIDE_THREADS, b, 0, False)
    if b * cluster > _GRID_LIMIT:
        raise ValueError(f"lap_auction: {b} instances exceed one launch")
    return AuctionPlan("cluster", 0, cluster, rows, CLUSTER_THREADS, b * cluster, smem, smem_rows)


def inverse_assignment(assign: torch.Tensor, out_size: int) -> torch.Tensor:
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


def lap_auction_plain(a, prices, col_of, eps, eps_min, thr, max_iters: int, tb=None, neg=NEG_INF):
    """Plain PyTorch version, written out over the batch: the loop runs
    while ANY instance is active and freezes each one exactly when its own
    ``while_loop`` would stop.  Returns ``(col_of (B, n) int64, prices
    (B, m) f32, iters (B,) int32, eps (B,) f32)``."""
    b, n, m = a.shape
    benefit = a if tb is None else fused_benefit(a, tb)
    cols = torch.arange(m, device=a.device)

    def bid_round(prices, col_of, eps):
        unassigned = col_of < 0
        vals = benefit - prices[:, None, :]
        best_j = torch.argmax(vals, dim=-1)
        best_v = torch.gather(vals, -1, best_j[..., None])[..., 0]
        second_v = vals.scatter(-1, best_j[..., None], neg).max(dim=-1).values
        incr = best_v - second_v + eps[:, None]
        offer = torch.gather(prices, 1, best_j) + incr
        # one-hot by comparison: F.one_hot validates its input with a sync
        bidding = unassigned[:, :, None] & (best_j[:, :, None] == cols)
        bids = torch.where(bidding, offer[:, :, None], -1e18)  # (B, n, m)
        has_bid = (bids > BID_FLOOR).any(dim=1)
        winner = torch.argmax(bids, dim=1)
        new_price = bids.max(dim=1).values
        prices = torch.where(has_bid, new_price, prices)
        row_of_prev = inverse_assignment(col_of, m)
        row_of = torch.where(has_bid, winner, row_of_prev)
        return prices, inverse_assignment(row_of, n)

    def active_fn(state):
        _, col_of, eps, it = state
        done = (col_of >= 0).all(dim=1) & (eps <= thr)
        return ~done & (it < max_iters)

    def body_fn(state):
        prices, col_of, eps, it = state
        phase = (col_of >= 0).all(dim=1) & (eps > thr)
        # both branches run on the whole batch, as under vmap's cond->select
        bid_p, bid_c = bid_round(prices, col_of, eps)
        col_of = torch.where(phase[:, None], -1, bid_c)
        prices = torch.where(phase[:, None], prices, bid_p)
        eps = torch.where(phase, torch.maximum(eps * EPS_STEP, eps_min), eps)
        return prices, col_of, eps, it + 1

    state = (prices, col_of.long(), eps, torch.zeros(b, dtype=torch.int32, device=a.device))
    prices, col_of, eps, iters = _run_loop(state, active_fn, body_fn, max_iters)
    return col_of, prices, iters, eps


def _check(a, prices, col_of, eps, eps_min, thr, tb) -> None:
    if a.ndim != 3:
        raise ValueError(f"lap_auction: want a (B, n, m), got {tuple(a.shape)}")
    b, n, m = a.shape
    want = {
        "prices": (prices, (b, m), (torch.float32,)),
        "col_of": (col_of, (b, n), (torch.int32, torch.int64)),
        "eps": (eps, (b,), (torch.float32,)),
        "eps_min": (eps_min, (b,), (torch.float32,)),
        "thr": (thr, (b,), (torch.float32,)),
    }
    if tb is not None:
        want["tb"] = (tb, (b,), (torch.float32,))
    if a.dtype != torch.float32:
        raise ValueError(f"lap_auction: want a float32, got {a.dtype}")
    for name, (t, shape, dtypes) in want.items():
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(
                f"lap_auction: {name} is {tuple(t.shape)} {t.dtype}, want {shape} "
                f"{' or '.join(str(d) for d in dtypes)} for a {tuple(a.shape)}"
            )
        if t.device != a.device:
            raise ValueError(f"lap_auction: {name} on {t.device}, a on {a.device}")


def lap_auction(
    a, prices, col_of, eps, eps_min, thr, max_iters: int, tb=None, neg=NEG_INF, plan=None
):
    """The whole auction over ``a`` (B, n, m), n <= m (see the module
    docstring for the arguments).  Returns ``(col_of (B, n) int64, prices
    (B, m) f32, iters (B,) int32, eps (B,) f32)``.

    CUDA tensors launch the kernel once (contiguous operands, counted in
    ``lap_auction.launches``) as ``plan`` says (default
    :func:`launch_plan`'s; the card tests pass others to reach each layout);
    CPU tensors take :func:`lap_auction_plain`.  Any other device raises.
    """
    _check(a, prices, col_of, eps, eps_min, thr, tb)
    if a.device.type == "cpu":
        return lap_auction_plain(a, prices, col_of, eps, eps_min, thr, max_iters, tb, neg)
    if a.device.type != "cuda":
        raise ValueError(f"lap_auction: unsupported device {a.device}")
    b, n, m = a.shape
    if not 0 <= max_iters < (1 << 31):
        raise ValueError(f"lap_auction: max_iters {max_iters} out of range")
    col_in = col_of.to(torch.int32).contiguous()
    operands = (a, prices, eps, eps_min, thr) + (() if tb is None else (tb,))
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("lap_auction: operands must be contiguous")
    col_out = torch.empty((b, n), dtype=torch.int32, device=a.device)
    p_out = torch.empty((b, m), dtype=torch.float32, device=a.device)
    it_out = torch.empty((b,), dtype=torch.int32, device=a.device)
    eps_out = torch.empty((b,), dtype=torch.float32, device=a.device)
    if b == 0:
        return col_out.long(), p_out, it_out, eps_out
    plan = plan or launch_plan(b, n, m)
    scratch = None
    if plan.regime == "wide":
        scratch = torch.empty(wide_scratch(b, n, m), dtype=torch.uint8, device=a.device)
    fn = build.library("lap_auction").lap_auction
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 4 + [ctypes.c_double] + [
        ctypes.c_int
    ] * 6 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(
            a.data_ptr(), None if tb is None else tb.data_ptr(), prices.data_ptr(),
            col_in.data_ptr(), eps.data_ptr(), eps_min.data_ptr(), thr.data_ptr(),
            col_out.data_ptr(), p_out.data_ptr(), it_out.data_ptr(), eps_out.data_ptr(),
            b, n, m, max_iters, float(neg), int(tb is not None), plan.group, plan.cluster,
            plan.rows_per_cta, plan.threads, int(plan.smem_rows), plan.smem,
            None if scratch is None else scratch.data_ptr(), stream,
        )
    build.check(err, "lap_auction")
    lap_auction.launches += 1
    return col_out.long(), p_out, it_out, eps_out


lap_auction.launches = 0
