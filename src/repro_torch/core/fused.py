"""The fused migrate stage: Algorithm 2 on the device with ONE readout per round.

Counterpart of the JAX package's ``core/fused.py`` (see that module for the
design and the exactness argument); the names and the contract are the
same.  The host planner (:func:`repro_torch.core.migration.plan_migration`,
algorithm ``node``) reads results back between its cost build, pair
fan-out and node match; here every step stays on the device:

* **device-resident invalidation** — last round's restricted slot matrices
  are cached on the device and node occupancy is diffed there, so one
  arrival or departure dirties only the pairs touching a changed physical
  or logical node (``dirty[i, j] = dirty_phys[i] | dirty_log[j]``).  Clean
  pairs re-enter the auction with their cached assignment and prices at
  ``eps_min`` and cost ZERO bid rounds.
* **in-program benefit assembly** — pair costs are assembled from the slot
  matrices and the scaled ``1/(2g)`` weight table (exact integers in f32);
  with ``tie_break`` the positional ramp ``tb * (i+1)^2 * (j+1)`` is added
  inside the bid.  With ``use_kernel`` every auction of the round (each
  chunk of the pair fan-out, then the node match) is ONE launch of the
  hand-written ``lap_auction`` CUDA kernel, which runs the whole loop on
  the card; for the pairs it assembles ``(ramp - cost) - price`` per
  element, so their benefit never exists as a tensor.
* **the pair-axis split** — JAX shards the pair axis over a device mesh
  with ``shard_map``; the port has one device, so ``shards`` splits the
  pair axis into that many chunks (padded with dummy clean pairs exactly
  as the mesh is) and solves them in turn.  Results and iteration totals
  do not depend on ``shards``.
* **one readout** — the plan, node assignment, matching cost, convergence
  flag and counters cross to the host in ONE ``.cpu()`` of a packed f64
  buffer (every value is an integer or an f32, exact in f64).  Kernel
  solves read nothing back; the plain loop's own ``any(active)`` flag reads
  (``use_kernel=False``, every
  :data:`~repro_torch.core.matching.auction.SYNC_EVERY` bid rounds) are
  counted apart, in ``auction.loop_syncs``.

Rounds outside the f32 mantissa budget, and rounds whose auctions do not
converge, fall back to the host planner (counted in
:attr:`FusedMigrationPlanner.stats`).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.cluster import EMPTY, PlacementPlan, count_migrations
from repro_torch.core.matching.auction import _NEG, _auction_square, _inverse_assignment
from repro_torch.core.migration import (
    MigrationResult,
    _cost_scale,
    _relabel_penalties,
    plan_migration,
)
from repro_torch.device import resolve_device
from repro_torch.obs.tracer import tracer_of

#: f32 mantissa budget: the largest scaled cost plus the finest tie-break
#: quantum must span fewer than 24 bits for the in-program f32 assembly to
#: be exact (see the JAX module's docstring).
_F32_MANTISSA = float(1 << 24)


def _tb_scale(n: int, m: int) -> float:
    """Positional tie-break scale for an (n, m) integer-cost instance —
    the ``quantum = 1`` branch of ``engine._tie_break_perturb``."""
    bound = 2.0 * min(n, m) * float(n) * float(n) * float(m)
    return float(2.0 ** np.floor(np.log2(1.0 / bound)))


def _ramp(n: int, m: int, device, dtype=torch.float32) -> torch.Tensor:
    """The (n, m) positional perturbation weights ``(i+1)^2 * (j+1)``."""
    gi = (torch.arange(n, dtype=dtype, device=device) + 1.0)[:, None]
    gj = (torch.arange(m, dtype=dtype, device=device) + 1.0)[None, :]
    return (gi * gi) * gj


def _pair_costs(pi_slots, pj_slots, weights_scaled):
    """All (kc, kc, kl, kl) scaled Algorithm-3 costs, on the device.

    Same computation as ``migration.pairwise_migration_cost`` over the full
    pair fan-out; EMPTY (-1) slots index the zero tail of the weight table
    through an explicit remap, never through wrap-around indexing (F3)."""
    zero_idx = weights_scaled.shape[0] - 1
    wu = weights_scaled[torch.where(pi_slots >= 0, pi_slots, zero_idx)]  # (kc, kl, P)
    wv = weights_scaled[torch.where(pj_slots >= 0, pj_slots, zero_idx)]
    eq = (
        pi_slots[:, None, :, None, :, None] == pj_slots[None, :, None, :, None, :]
    )  # (kc, kc, kl, kl, P, P)
    u_in_v = eq.any(-1)
    v_in_u = eq.any(-2)
    cost_out = (wu[:, None, :, None, :] * ~u_in_v).sum(-1)
    cost_in = (wv[None, :, None, :, :] * ~v_in_u).sum(-1)
    return cost_out + cost_in


def _pair_auction(
    cost, eps_min, init_prices, init_col_of, warm, max_iters, use_kernel, tb, fused=True
):
    """Square Jacobi auctions with explicit initial state over a (B, n, n)
    raw scaled COST batch.  A warm instance whose initial assignment is
    already complete stops with ZERO bid rounds (the clean-pair fast path).

    ``use_kernel`` runs the whole auction as the ``lap_auction`` CUDA kernel
    (its plain version for CPU tensors).  With ``fused`` (the pair fan-out)
    the kernel assembles ``(tb * (i+1)^2) * (j+1) - cost`` per element as
    the fused bid kernel does, with its ``-1e30`` "no second column" value;
    otherwise (the node match, and every ``use_kernel=False`` solve) the
    benefit ``tb * ramp - cost`` is built once here, with the plain top-2's
    ``-1e18``.  The two assemblies agree bit for bit while ``(i+1)^2 (j+1)``
    is exact in f32, which the node match's (kc = 512) is not.  The
    starting epsilon scales with the cost's span, as in JAX.  Returns
    ``(col_of, prices, iters, converged)``, each with the batch axis."""
    span = torch.clamp_min(cost.abs().amax(dim=(1, 2)), 1.0)
    if use_kernel and fused:
        tbv = torch.full((cost.shape[0],), tb, dtype=torch.float32, device=cost.device)
        res = _auction_square(
            cost, eps_min, max_iters, True, init_prices, warm, init_col_of, span=span, tb=tbv
        )
    else:
        benefit = tb * _ramp(cost.shape[-2], cost.shape[-1], cost.device, cost.dtype) - cost
        res = _auction_square(
            benefit, eps_min, max_iters, use_kernel, init_prices, warm, init_col_of,
            span=span, neg=_NEG,
        )
    return res.col_of, res.prices, res.iters, res.converged


def _fused_round(
    pi_slots,        # (kc, kl, P) int64 — restricted PREV (physical) plan
    pj_slots,        # (kc, kl, P) int64 — restricted NEW (logical) plan
    new_slots,       # (kc, kl, P) int64 — FULL new logical plan (scatter src)
    weights_scaled,  # (max_id + 2,) f32 — scale/(2g) per job id, zero tail
    pen_scaled,      # (kc, kc) f32 — scaled relabel penalties (zeros if none)
    cache_pi,        # (kc, kl, P) — last round's pi_slots
    cache_pj,
    cache_col_of,    # (kc*kc, kl) — last round's pair assignments
    cache_prices,    # (kc*kc, kl) f32 — last round's pair prices
    cache_node_prices,  # (kc,) f32
    cache_valid: bool,  # known on the host: no readout needed to branch on it
    *,
    kc: int,
    kl: int,
    shards: int,
    max_iters: int,
    use_kernel: bool,
    tb_pair: float,  # 0.0 = tie-break off
    tb_node: float,
):
    """One fused migration round: diff -> assemble -> pair fan-out (in
    ``shards`` chunks) -> node match -> physical scatter, all on the device
    with no readout.  Indices that are -1 on a round that did not converge
    are clamped before every gather, so such a round reaches its host
    fallback cleanly (its results are thrown away)."""
    dev = pi_slots.device
    n_pairs = kc * kc
    eps_pair = (tb_pair if tb_pair > 0.0 else 1.0) / (kl + 1)
    eps_node = (tb_node if tb_node > 0.0 else 1.0) / (kc + 1)

    # --- per-node occupancy diff -> per-pair dirty mask ------------------ #
    dirty_i = (pi_slots != cache_pi).flatten(1).any(dim=1) | (not cache_valid)
    dirty_j = (pj_slots != cache_pj).flatten(1).any(dim=1) | (not cache_valid)
    dirty = (dirty_i[:, None] | dirty_j[None, :]).reshape(n_pairs)

    # --- in-program cost assembly (exact integers in f32) ---------------- #
    cost_p = _pair_costs(pi_slots, pj_slots, weights_scaled).reshape(n_pairs, kl, kl)

    # clean pairs re-enter at their cached optimum (zero bid rounds);
    # dirty pairs warm-start from cached prices when the cache is live
    arange_kl = torch.arange(kl, dtype=torch.int64, device=dev)
    init_col = torch.where(dirty[:, None], -1, cache_col_of)
    init_prices = cache_prices if cache_valid else torch.zeros_like(cache_prices)
    warm = ~dirty | cache_valid  # clean: eps_min re-entry; dirty+cache: warm lane

    # --- the pair fan-out, split into `shards` chunks --------------------- #
    pad = (-n_pairs) % shards
    if pad:
        # dummy clean pairs: identity assignment, zero prices, zero cost —
        # they stop at once; results are sliced off below
        cost_p = torch.cat([cost_p, cost_p.new_zeros((pad, kl, kl))])
        init_col = torch.cat([init_col, arange_kl.expand(pad, kl)])
        init_prices = torch.cat([init_prices, init_prices.new_zeros((pad, kl))])
        warm = torch.cat([warm, warm.new_ones((pad,))])
    chunk = cost_p.shape[0] // shards
    parts = [
        _pair_auction(
            cost_p[s:s + chunk], eps_pair, init_prices[s:s + chunk],
            init_col[s:s + chunk], warm[s:s + chunk], max_iters, use_kernel, tb_pair,
        )
        for s in range(0, cost_p.shape[0], chunk)
    ]
    col_of, prices, iters, conv = (torch.cat(xs)[:n_pairs] for xs in zip(*parts))
    cost_p = cost_p[:n_pairs]

    # --- node match over pair totals ------------------------------------- #
    picked = torch.gather(cost_p, 2, col_of.clamp_min(0)[:, :, None])
    total_scaled = picked[:, :, 0].sum(dim=1)  # (n_pairs,)
    node_cost = total_scaled.reshape(kc, kc) + pen_scaled
    node_col, node_prices, node_iters, node_conv = _pair_auction(
        node_cost[None],
        eps_node,
        (cache_node_prices if cache_valid else torch.zeros_like(cache_node_prices))[None],
        None,
        torch.tensor([cache_valid], device=dev),
        max_iters,
        use_kernel,
        tb_node,
        fused=False,  # the plain assembly: tb * ramp is not exact at kc = 512
    )
    node_col, node_prices = node_col[0], node_prices[0]

    # --- physical scatter (argsort == host gpu_assign, inverse == host
    # node_assignment[n_cols] = n_rows) ----------------------------------- #
    node_assignment = _inverse_assignment(node_col, kc)  # logical l -> physical k
    node_k = node_assignment.clamp_min(0)
    gpu_assign = torch.argsort(col_of, dim=-1)  # (n_pairs, kl) v -> u
    pair_idx = node_k * kc + torch.arange(kc, dtype=torch.int64, device=dev)
    u_of_v = gpu_assign[pair_idx]  # (kc_logical, kl)
    phys = torch.full_like(new_slots, EMPTY)
    phys[node_k[:, None], u_of_v] = new_slots

    matching_cost_scaled = torch.gather(node_cost, 1, node_col.clamp_min(0)[:, None])[:, 0].sum()
    converged = conv.all() & node_conv[0]
    stats = torch.stack([iters.sum(), node_iters[0].to(torch.int64), dirty.sum()])
    return (
        phys,
        node_assignment,
        matching_cost_scaled,
        converged,
        stats,
        col_of,
        prices,
        node_prices,
        pi_slots,
        pj_slots,
    )


class FusedMigrationPlanner:
    """Device-resident Algorithm-2 planner: one device program and one
    readout per round (see module docstring).

    Drop-in for the scheduler's migrate stage (``fused_fanout=True``):
    :meth:`plan` has the :func:`~repro_torch.core.migration.plan_migration`
    contract for ``algorithm="node"`` and returns the same
    :class:`MigrationResult` (``algorithm="node-fused"``).  Rounds the
    fused program cannot serve exactly — f32 mantissa budget exceeded, or an
    auction hitting ``max_iters`` — fall back to the host planner and
    invalidate the device cache; both are counted in :attr:`stats`.
    ``use_kernel=None`` runs the round's auctions on the ``lap_auction``
    CUDA kernel when ``device`` is CUDA and on its plain version otherwise;
    ``device=None`` is CUDA.
    """

    def __init__(
        self,
        shards: int = 1,
        use_kernel: Optional[bool] = None,
        max_iters: int = 20_000,
        obs=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.shards = max(1, int(shards))
        self.use_kernel = (
            self.device.type == "cuda" if use_kernel is None else bool(use_kernel)
        )
        self.max_iters = int(max_iters)
        #: opt-in observability bundle — spans around the fused program,
        #: its single readout, and host fallbacks.  Pure host-side
        #: bookkeeping: no extra device work, no decision inputs touched.
        self.obs = obs
        self._cache = None  # device tensors: pi, pj, col_of, prices, node_prices
        self._cache_key = None  # (kc, kl, P, scale, tie_break)
        #: why the most recent :meth:`plan` call fell back to the host
        #: planner (``"fused-budget"`` / ``"fused-nonconverged"``), or
        #: ``None`` when it was served fused.  The scheduler folds this
        #: into the round's ``DegradeReason``.
        self.last_fallback_reason: Optional[str] = None
        self.stats: Dict[str, int] = {
            "fused_rounds": 0,
            "fused_host_fallbacks": 0,
            "fused_budget_fallbacks": 0,
            "fused_nonconverged_fallbacks": 0,
            "fused_dirty_pairs": 0,
            "fused_pair_instances": 0,
            "fused_bid_iters": 0,
            "fused_readouts": 0,
        }

    def invalidate(self) -> None:
        self._cache = None
        self._cache_key = None

    def invalidate_nodes(self, nodes) -> None:
        """TARGETED invalidation: poison only the cached occupancy rows of
        the given physical/logical nodes (node-down / node-up events), so
        next round's diff marks exactly the pairs touching them dirty while
        every healthy pair stays clean (zero bid rounds).  The poison value
        ``-2`` can never equal a real slot id (ids are >= -1), so the dirty
        bit trips even if the node's occupancy is coincidentally
        unchanged."""
        if self._cache is None:
            return
        idx = sorted(int(n) for n in nodes)
        if not idx:
            return
        pi, pj, col_of, prices, node_prices = self._cache
        idx_t = torch.tensor(idx, dtype=torch.int64, device=pi.device)
        pi = pi.index_fill(0, idx_t, -2)
        pj = pj.index_fill(0, idx_t, -2)
        self._cache = (pi, pj, col_of, prices, node_prices)

    def plan(
        self,
        prev: PlacementPlan,
        new_logical: PlacementPlan,
        num_gpus_of: Dict[int, int],
        tie_break: bool = False,
        down_nodes: Optional[np.ndarray] = None,
        speed_factor: Optional[np.ndarray] = None,
    ) -> MigrationResult:
        tracer = tracer_of(self.obs)
        with tracer.span(
            "migrate.fused", shards=self.shards, kernel=self.use_kernel
        ) as sp:
            before = dict(self.stats)
            res = self._plan_impl(
                prev, new_logical, num_gpus_of, tie_break, down_nodes,
                speed_factor, tracer,
            )
            sp.annotate(
                fallback=self.last_fallback_reason or "none",
                dirty_pairs=self.stats["fused_dirty_pairs"]
                - before["fused_dirty_pairs"],
                bid_iters=self.stats["fused_bid_iters"]
                - before["fused_bid_iters"],
                readouts=self.stats["fused_readouts"]
                - before["fused_readouts"],
                migrations=res.num_migrations,
            )
        return res

    def _plan_impl(
        self,
        prev: PlacementPlan,
        new_logical: PlacementPlan,
        num_gpus_of: Dict[int, int],
        tie_break: bool,
        down_nodes: Optional[np.ndarray],
        speed_factor: Optional[np.ndarray],
        tracer,
    ) -> MigrationResult:
        t0 = time.perf_counter()
        self.last_fallback_reason = None
        cluster = prev.cluster
        kc, kl = cluster.num_nodes, cluster.gpus_per_node
        pmax = prev.slots.shape[-1]
        scale = _cost_scale(num_gpus_of, "auction")
        tb_pair = _tb_scale(kl, kl) if tie_break else 0.0
        tb_node = _tb_scale(kc, kc) if tie_break else 0.0

        # Health terms enter the fused program EXACTLY as the host planner
        # computes them: the same _relabel_penalties matrix is scaled and
        # added to the node cost, and its magnitude counts against the same
        # f32 mantissa budget below.
        occupied_logical = (new_logical.slots != EMPTY).any(axis=(1, 2))
        pen = _relabel_penalties(
            cluster, down_nodes, occupied_logical, speed_factor
        )
        pen_max = 0.0 if pen is None else float(pen.max())

        # f32 exactness budget: the largest scaled node-cost magnitude (each
        # pair cell is <= 2 * MAX_PACK * 1/2 * scale, a pair total sums kl
        # cells, plus the relabel penalty) against the finest tie-break
        # quantum.  Outside the budget the fused program could mis-round —
        # serve the round from the host instead.
        quantum = min(tb_pair or 1.0, tb_node or 1.0)
        max_abs = (2.0 * pmax * kl + pen_max) * scale
        if max_abs / quantum >= _F32_MANTISSA:
            self.stats["fused_host_fallbacks"] += 1
            self.stats["fused_budget_fallbacks"] += 1
            self.last_fallback_reason = "fused-budget"
            self.invalidate()
            with tracer.span("migrate.fused.host_fallback", reason="fused-budget"):
                return self._host(
                    prev, new_logical, num_gpus_of, tie_break, down_nodes,
                    speed_factor,
                )

        common = prev.job_ids() & new_logical.job_ids()
        pi = prev.restricted_to(common).slots
        pj = new_logical.restricted_to(common).slots

        max_id = max(num_gpus_of) if num_gpus_of else 0
        weights = np.zeros(max_id + 2, np.float32)
        for j, g in num_gpus_of.items():
            weights[j] = scale / (2.0 * g)  # an integer: scale is the lcm of every 2*g
        pen_scaled = (
            np.zeros((kc, kc), np.float32)
            if pen is None
            else (pen * scale).astype(np.float32)
        )

        # NOT keyed on max_id: the weights table regrows as job ids climb,
        # but a clean pair's slots pin the exact same ids (and per-id
        # num_gpus is immutable), so its cached cost/assignment stays valid
        key = (kc, kl, pmax, scale, tie_break)
        if self._cache_key != key:
            self.invalidate()
        dev = self.device
        cache_valid = self._cache is not None
        if cache_valid:
            cache = self._cache
        else:
            cache = (
                torch.zeros((kc, kl, pmax), dtype=torch.int64, device=dev),
                torch.zeros((kc, kl, pmax), dtype=torch.int64, device=dev),
                torch.arange(kl, dtype=torch.int64, device=dev).expand(kc * kc, kl),
                torch.zeros((kc * kc, kl), dtype=torch.float32, device=dev),
                torch.zeros((kc,), dtype=torch.float32, device=dev),
            )

        def on_dev(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

        with tracer.span("migrate.fused.program", kc=kc, kl=kl):
            out = _fused_round(
                on_dev(pi, np.int64),
                on_dev(pj, np.int64),
                on_dev(new_logical.slots, np.int64),
                on_dev(weights, np.float32),
                on_dev(pen_scaled, np.float32),
                *cache,
                cache_valid,
                kc=kc,
                kl=kl,
                shards=self.shards,
                max_iters=self.max_iters,
                use_kernel=self.use_kernel,
                tb_pair=tb_pair,
                tb_node=tb_node,
            )
        # THE readout: everything host-side comes off the device here, once
        phys_dev, node_assign_dev, cost_dev, conv_dev, stats_dev = out[:5]
        with tracer.span("migrate.fused.readout"):
            packed = torch.cat([
                phys_dev.reshape(-1).double(),
                node_assign_dev.double(),
                cost_dev.double().reshape(1),
                conv_dev.double().reshape(1),
                stats_dev.double(),
            ]).cpu().numpy()
        self.stats["fused_readouts"] += 1
        n_phys = phys_dev.numel()
        phys = packed[:n_phys].astype(np.int64).reshape(phys_dev.shape)
        node_assignment = packed[n_phys:n_phys + kc].astype(np.int64)
        cost_scaled, converged = packed[n_phys + kc], packed[n_phys + kc + 1]
        stats = packed[n_phys + kc + 2:].astype(np.int64)

        if not converged:
            self.stats["fused_host_fallbacks"] += 1
            self.stats["fused_nonconverged_fallbacks"] += 1
            self.last_fallback_reason = "fused-nonconverged"
            self.invalidate()
            with tracer.span(
                "migrate.fused.host_fallback", reason="fused-nonconverged"
            ):
                return self._host(
                    prev, new_logical, num_gpus_of, tie_break, down_nodes,
                    speed_factor,
                )

        # cache stays device-resident for next round's diff / warm start
        self._cache = (out[8], out[9], out[5], out[6], out[7])
        self._cache_key = key
        self.stats["fused_rounds"] += 1
        self.stats["fused_pair_instances"] += kc * kc
        self.stats["fused_dirty_pairs"] += int(stats[2])
        self.stats["fused_bid_iters"] += int(stats[0]) + int(stats[1])

        phys_plan = PlacementPlan(cluster, phys)
        n_mig = count_migrations(prev, phys_plan)
        return MigrationResult(
            phys_plan,
            n_mig,
            float(cost_scaled) / scale,
            node_assignment,
            time.perf_counter() - t0,
            "node-fused",
        )

    def _host(
        self,
        prev,
        new_logical,
        num_gpus_of,
        tie_break,
        down_nodes=None,
        speed_factor=None,
    ) -> MigrationResult:
        res = plan_migration(
            prev,
            new_logical,
            num_gpus_of,
            algorithm="node",
            backend="auto",
            tie_break=tie_break,
            down_nodes=down_nodes,
            speed_factor=speed_factor,
            device=self.device,
        )
        return MigrationResult(
            res.physical_plan,
            res.num_migrations,
            res.matching_cost,
            res.node_assignment,
            res.wall_time_s,
            "node-fused-fallback",
        )
