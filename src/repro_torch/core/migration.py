"""Migration minimisation (§4.1): Algorithms 2, 3 and 5 + Gavel baseline.

Key idea (Fig. 1): two placement plans that *look* different may be
identical up to GPU renaming — so before physically moving any job, find
the GPU/node relabelling of the new plan that minimises the number of true
migrations.  With homogeneous GPUs this is exactly an assignment problem:

* **Algorithm 3** (node-level matching): for one node from round i and one
  node from round i+1, build the k_l x k_l cost matrix
  ``C[u, v] = sum_{j in JS_u symdiff JS_v} 1 / (2 * num_gpus(j))``
  (each move-in or move-out costs 0.5 per job, amortised over the job's
  GPUs) and solve it with the Hungarian algorithm.
* **Algorithm 2** (job migration): drop jobs not present in both rounds,
  run Algorithm 3 for every node pair to get a k_c x k_c node-level cost
  matrix, then a second Hungarian assignment picks which *physical* node
  hosts each node-worth of the new plan.  Matching at node granularity
  preserves consolidated placement (§4.3).
* **Algorithm 5** (appendix B): flat GPU-level matching over the whole
  cluster — cheaper (O(k^3)) but may break consolidation (Example 5).
* **Gavel baseline**: no relabelling at all; a job migrates whenever its
  logical GPU ids differ between rounds.  (The "basic migration algorithm"
  Tesserae improves on by 36%, Fig. 11.)

Semantic note (found by property testing, EXPERIMENTS.md): the Hungarian
objective minimises the paper's FRACTIONAL cost (each moved GPU of a job
costs 1/(2*num_gpus)), which equals the migration count only when jobs
move atomically.  A multi-GPU job moving PARTIALLY scores < 1 but still
counts as one migration under Definition 1, so on adversarial plans the
optimal-cost assignment can have a (slightly) higher integer count than
no-remap.  In end-to-end traces this never dominates: the simulator
measures 60% fewer migrations than the no-remap baseline (Fig. 11 repro).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core.cluster import EMPTY, MAX_PACK, PlacementPlan, count_migrations
from repro_torch.core.matching import MatchContext, solve_lap, solve_lap_batched
from repro_torch.core.matching.engine import APPROX_BACKENDS
from repro_torch.device import device_timer, resolve_device
from repro_torch.kernels.ops import migration_cost_matrix
from repro_torch.obs.tracer import NULL_TRACER


# --------------------------------------------------------------------------- #
# Cost-matrix construction
# --------------------------------------------------------------------------- #
def _weight_lookup(num_gpus_of: Dict[int, int]) -> np.ndarray:
    """Dense job-id -> 1/(2*num_gpus) lookup; index -1 (EMPTY) maps to 0."""
    max_id = max(num_gpus_of) if num_gpus_of else 0
    w = np.zeros(max_id + 2, dtype=np.float64)
    for j, g in num_gpus_of.items():
        w[j] = 1.0 / (2.0 * g)
    # EMPTY == -1 indexes the last element, which stays 0.
    return w


def pairwise_migration_cost(
    slots_u: np.ndarray, slots_v: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """Cost matrix between two GPU lists (Algorithm 3 lines 2-7).

    ``slots_u``: (..., U, MAX_PACK) job ids, ``slots_v``: (..., V, MAX_PACK).
    Returns (..., U, V) with
    ``C[u, v] = sum_{j in set(u) symdiff set(v)} weights[j]``.

    This numpy body is the host reference; :func:`_gpu_pair_costs` computes
    the same matrix on the scheduler's device through the hand-written
    ``migration_cost`` kernel (``repro_torch/kernels/migration_cost.py``),
    bit for bit.
    """
    su = slots_u[..., :, None, :, None]  # (..., U, 1, P, 1)
    sv = slots_v[..., None, :, None, :]  # (..., 1, V, 1, P)
    eq = su == sv  # (..., U, V, P, P)
    u_in_v = eq.any(axis=-1)  # (..., U, V, P): job a of u present in v
    v_in_u = eq.any(axis=-2)  # (..., U, V, P): job b of v present in u
    wu = weights[slots_u]  # EMPTY -> 0 via lookup tail
    wv = weights[slots_v]
    cost_out = (wu[..., :, None, :] * ~u_in_v).sum(axis=-1)
    cost_in = (wv[..., None, :, :] * ~v_in_u).sum(axis=-1)
    return cost_out + cost_in


#: Extra node-relabel cost for crossing a rack boundary: checkpoints must
#: transit the aggregation layer, so the relabelling only does it when it
#: saves at least one half-migration.  A multiple of 1/2 keeps the
#: auction's integer quantisation exact (the cost scale is always even).
CROSS_RACK_COST = 0.5

#: Straggler-drain weight: a fully-degraded node (speed 0) charges this many
#: matching-cost units PER NODE GPU for hosting an occupied logical row, so
#: draining a whole node's worth of jobs (~``gpus_per_node`` half-migrations
#: in and out) is worth it whenever the capacity loss exceeds the move.
#: Partial degradation scales linearly and is rounded to multiples of 1/2,
#: keeping the auction's integer quantisation exact (cost scale is even).
STRAGGLER_DRAIN_COST = 1.0


def _relabel_penalties(
    cluster,
    down_nodes: Optional[np.ndarray] = None,
    occupied_logical: Optional[np.ndarray] = None,
    speed_factor: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """(kc, kc) additive node-relabel penalties for heterogeneous / racked
    / partially-down clusters: ``pen[k, l]`` is added to the cost of
    hosting logical node ``l`` on physical node ``k``.

    * GPU-type mismatch gets a penalty strictly larger than any achievable
      real matching cost (``2 * kl * kc`` bounds the total), making the
      relabelling TYPE-PRESERVING: a plan row laid out for an A100 node is
      never silently renamed onto a V100 node (which would invalidate every
      throughput belief behind the plan).  Always feasible — the identity
      relabelling is type-preserving by construction.
    * Crossing a rack boundary costs :data:`CROSS_RACK_COST`.
    * A DOWN physical node is zero capacity: hosting any *occupied*
      logical row on it costs twice the mismatch bound, strictly
      dominating every real-cost + mismatch + rack combination, so the
      optimum never lands jobs there (the identity relabelling is always
      feasible and cheaper — health-aware placement left down nodes'
      logical rows empty).  Empty logical rows relabel onto down nodes
      freely, which keeps the assignment square and feasible.
    * A DEGRADED physical node (``speed_factor[k] < 1``) charges a
      *finite* drain penalty proportional to its capacity loss
      (:data:`STRAGGLER_DRAIN_COST` units per node GPU at 100%
      degradation) for hosting any occupied logical row.  Unlike the
      down-node term this competes with real matching costs: the optimum
      drains jobs off stragglers exactly when spare healthy capacity
      exists and the move is cheaper than the penalty — a saturated
      cluster keeps running slow rather than thrash.

    Returns ``None`` for healthy homogeneous single-rack clusters — the
    seed path, where the node cost matrix is untouched (bit-for-bit).
    """
    hetero = cluster.is_heterogeneous
    racked = cluster.has_topology
    downs = (
        np.asarray([], dtype=np.int64)
        if down_nodes is None
        else np.asarray(sorted(int(n) for n in down_nodes), dtype=np.int64)
    )
    slow = None
    if speed_factor is not None:
        sf = np.asarray(speed_factor, dtype=np.float64)
        if (sf != 1.0).any():
            slow = sf
    if not hetero and not racked and len(downs) == 0 and slow is None:
        return None
    kc = cluster.num_nodes
    pen = np.zeros((kc, kc), dtype=np.float64)
    base = 2.0 * cluster.gpus_per_node * kc + 1.0
    if hetero:
        types = np.array(cluster.node_types())
        pen += base * (types[:, None] != types[None, :])
    if racked:
        racks = np.array([cluster.rack_of(i) for i in range(kc)])
        pen += CROSS_RACK_COST * (racks[:, None] != racks[None, :])
    if slow is not None:
        occ = (
            np.ones(kc, dtype=bool)
            if occupied_logical is None
            else np.asarray(occupied_logical, dtype=bool)
        )
        # round UP to half-units so every drain penalty stays on the
        # auction's integer grid after scaling (scale is always even)
        loss = np.clip(1.0 - slow, 0.0, 1.0)
        half_units = np.ceil(
            loss * 2.0 * STRAGGLER_DRAIN_COST * cluster.gpus_per_node
        )
        pen += (0.5 * half_units)[:, None] * occ[None, :]
    if len(downs):
        down_mask = np.zeros(kc, dtype=bool)
        down_mask[downs] = True
        occ = (
            np.ones(kc, dtype=bool)
            if occupied_logical is None
            else np.asarray(occupied_logical, dtype=bool)
        )
        pen += (2.0 * base) * (down_mask[:, None] & occ[None, :])
    return pen


def _penalty_span(tracer, cluster):
    """A ``migrate.penalties`` span (``types``: distinct GPU types,
    ``racks``) where the cluster's types or racks add relabel penalties;
    none on a single-type, single-rack cluster."""
    if not (cluster.is_heterogeneous or cluster.has_topology):
        return contextlib.nullcontext()
    return tracer.span(
        "migrate.penalties",
        types=len(set(cluster.node_types())),
        racks=cluster.num_racks,
    )


def _cost_scale(num_gpus_of: Dict[int, int], backend: str) -> float:
    """Quantisation scale for the approximate (auction) backends.

    Migration costs are multiples of ``1/(2*num_gpus)``; multiplying by the
    lcm of the ``2*g`` values makes every cost an integer, for which the
    auction's final epsilon guarantees exact optimality.  Exact backends
    need no scaling.
    """
    if backend not in APPROX_BACKENDS:
        return 1.0
    gs = sorted(set(num_gpus_of.values())) or [1]
    return float(np.lcm.reduce([2 * g for g in gs]))


def node_level_matching(
    node_slots_i: np.ndarray,
    node_slots_j: np.ndarray,
    num_gpus_of: Dict[int, int],
    backend: str = "auto",
    device=None,
):
    """Algorithm 3 for a single node pair (``device`` runs an auction
    backend; the exact backends stay on the host).

    Returns ``(cost_sum, gpu_assignment)`` where ``gpu_assignment[v] = u``:
    logical GPU v of the new plan lands on physical GPU u.
    """
    weights = _weight_lookup(num_gpus_of)
    cost = pairwise_migration_cost(node_slots_i, node_slots_j, weights)
    rows, cols = solve_lap(
        cost * _cost_scale(num_gpus_of, backend), backend=backend, device=device
    )
    assign = np.empty(cost.shape[0], dtype=np.int64)
    assign[cols] = rows
    return float(cost[rows, cols].sum()), assign


def _gpu_pair_costs(
    slots_u: np.ndarray,
    slots_v: np.ndarray,
    weights: np.ndarray,
    device,
    tracer=NULL_TRACER,
) -> np.ndarray:
    """(U, V) GPU-pair cost matrix of two (U, MAX_PACK) / (V, MAX_PACK) slot
    lists, built on ``device`` (the ``migration_cost`` kernel on CUDA, its
    plain version on the CPU) and read back once as host f64 — the engine
    takes host arrays at its entry.  ``tracer`` gets a ``migrate.cost``
    span from the uploads to the host matrix, with the kernel's device time
    on CUDA."""
    with tracer.span("migrate.cost", syncs=1) as sp:
        with device_timer(sp, device) as timer:
            cost = migration_cost_matrix(slots_u, slots_v, weights, device, timer)
            return cost.cpu().numpy()


# --------------------------------------------------------------------------- #
# Full migration planning
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class MigrationResult:
    #: physical realisation of the new round's plan after relabelling.
    physical_plan: PlacementPlan
    #: number of true migrations (Definition 1) prev -> physical_plan.
    num_migrations: int
    #: total Hungarian matching cost (== migration count when jobs move
    #: atomically; fractional when jobs move partially).
    matching_cost: float
    #: node_assignment[l] = physical node hosting logical node l (node
    #: level only).
    node_assignment: Optional[np.ndarray]
    wall_time_s: float
    algorithm: str


def plan_migration(
    prev: PlacementPlan,
    new_logical: PlacementPlan,
    num_gpus_of: Dict[int, int],
    algorithm: str = "node",  # "node" (Alg 2+3) | "flat" (Alg 5) | "none"
    backend: str = "auto",
    context: Optional[MatchContext] = None,
    tie_break: bool = False,
    down_nodes: Optional[np.ndarray] = None,
    speed_factor: Optional[np.ndarray] = None,
    device=None,
    tracer=NULL_TRACER,
) -> MigrationResult:
    """Compute the relabelling that minimises migrations, then apply it to
    the *full* new plan (jobs unique to one round are excluded from the cost
    computation — Algorithm 2 line 2 — but follow their logical GPU).

    ``backend`` is any engine backend (``auto`` / ``numpy`` / ``scipy`` /
    ``auction`` / ``auction_kernel``) — one knob selects the solver for
    both the node-pair fan-out and the final node-level match.
    ``context`` threads the scheduler's :class:`MatchContext` across
    rounds, keyed by IDENTITY: each fan-out instance is a (physical node,
    logical node) pair and its rows/columns are global GPU slots, the
    final match is keyed by node ids, and the flat algorithm by GPU ids.
    Node pairs whose cost rows did not change since the previous round
    memo-hit outright (they never occupy solver lanes — partial-batch
    compaction) and changed pairs warm-start from last round's auction
    prices; identity keying keeps all of that valid if the cluster itself
    is ever resized between rounds.

    On heterogeneous / racked clusters the node-level cost gains the
    :func:`_relabel_penalties` terms (type-preserving relabelling, rack
    locality); ``matching_cost`` then includes those penalties.
    ``tie_break`` threads the engine's canonical tie-break perturbation
    through every LAP so equally-optimal relabellings are
    solver-independent.  ``down_nodes`` marks failed physical nodes: the
    relabelling is penalised off them (see :func:`_relabel_penalties`),
    so no occupied logical row is ever renamed onto a dead node.
    ``speed_factor`` (per-physical-node, from ``ClusterHealth``) adds the
    finite straggler-drain term: degraded nodes are drained through the
    same matching objective whenever healthy spare capacity makes the
    move worthwhile.  ``device`` builds the Algorithm-3 cost matrix and
    runs the auction solves (default: the context's device, else CUDA).

    ``tracer`` gets the stages as spans: ``migrate.prepare`` (the plans
    restricted to the common jobs, the weight table), ``migrate.cost`` (K5
    and its read-back), the engine's ``lap.solve`` spans,
    ``migrate.penalties`` (the type and rack terms added to the costs, on
    a typed or racked cluster only) and ``migrate.assemble`` (the physical
    plan and its migration count).
    """
    t0 = time.perf_counter()
    cluster = prev.cluster
    if algorithm == "none":
        phys = new_logical.copy()
        n_mig = count_migrations(prev, phys)
        return MigrationResult(
            phys, n_mig, float(n_mig), None, time.perf_counter() - t0, algorithm
        )

    with tracer.span("migrate.prepare"):
        occupied_logical = (new_logical.slots != EMPTY).any(axis=(1, 2))
        common = prev.job_ids() & new_logical.job_ids()
        pi = prev.restricted_to(common)
        pj = new_logical.restricted_to(common)
        weights = _weight_lookup(num_gpus_of)
        if device is not None or context is None:
            dev = resolve_device(device)
        else:
            dev = context.device

    if algorithm == "flat":
        flat_i = pi.slots.reshape(-1, MAX_PACK)
        flat_j = pj.slots.reshape(-1, MAX_PACK)
        cost = _gpu_pair_costs(flat_i, flat_j, weights, dev, tracer=tracer)
        with _penalty_span(tracer, cluster):
            pen = _relabel_penalties(
                cluster, down_nodes, occupied_logical, speed_factor
            )
            if pen is not None:
                # expand node-level penalties to every (physical, logical)
                # GPU pair: each relabelled GPU's state crosses the boundary
                kl = cluster.gpus_per_node
                cost = cost + np.repeat(np.repeat(pen, kl, axis=0), kl, axis=1)
        gpu_ids = np.arange(cluster.num_gpus, dtype=np.int64)
        rows, cols = solve_lap(
            cost * _cost_scale(num_gpus_of, backend),
            backend=backend,
            context=context,
            context_key="migration_flat",
            row_ids=gpu_ids,
            col_ids=gpu_ids,
            tie_break=tie_break,
            device=dev,
        )
        with tracer.span("migrate.assemble"):
            gpu_of_logical = np.empty(cluster.num_gpus, dtype=np.int64)
            gpu_of_logical[cols] = rows
            phys_slots = np.full_like(new_logical.slots, EMPTY)
            flat_new = new_logical.slots.reshape(-1, MAX_PACK)
            phys_flat = phys_slots.reshape(-1, MAX_PACK)
            for v in range(cluster.num_gpus):
                phys_flat[gpu_of_logical[v]] = flat_new[v]
            phys = PlacementPlan(cluster, phys_slots)
            n_mig = count_migrations(prev, phys)
        return MigrationResult(
            phys,
            n_mig,
            float(cost[rows, cols].sum()),
            None,
            time.perf_counter() - t0,
            algorithm,
        )

    if algorithm != "node":
        raise ValueError(f"unknown migration algorithm {algorithm!r}")

    # --- Algorithm 2: node-pair costs via vectorised Algorithm 3 --------- #
    # The k_c^2 independent k_l x k_l LAPs solve as ONE batched engine call;
    # the backend knob picks smallperm/scipy ("auto") or the torch auction
    # ("auction"/"auction_kernel", quantised to integers so the final
    # epsilon guarantees per-instance optimality).
    kc = cluster.num_nodes
    kl = cluster.gpus_per_node
    # (kc, kc, kl, kl): cost matrix for every (node_i, node_j) pair — the
    # whole (kc*kl) x (kc*kl) GPU-pair matrix, viewed per node pair.
    all_costs = (
        _gpu_pair_costs(
            pi.slots.reshape(-1, MAX_PACK),
            pj.slots.reshape(-1, MAX_PACK),
            weights,
            dev,
            tracer=tracer,
        )
        .reshape(kc, kl, kc, kl)
        .transpose(0, 2, 1, 3)
    )
    scale = _cost_scale(num_gpus_of, backend)
    # identity keying: instance (i, j) is the (physical, logical) node
    # pair; its rows/cols are the GLOBAL GPU slots of those nodes.  Stable
    # across rounds (and across cluster resizes) by construction.
    node_ids = np.arange(kc, dtype=np.int64)
    pair_ids = (node_ids[:, None] * (1 << 20) + node_ids[None, :]).ravel()
    slot_ids = node_ids[:, None] * kl + np.arange(kl, dtype=np.int64)[None, :]
    res = solve_lap_batched(
        all_costs.reshape(kc * kc, kl, kl) * scale,
        backend=backend,
        context=context,
        context_key="migration_pairs",
        instance_ids=pair_ids,
        row_ids=np.repeat(slot_ids, kc, axis=0),
        col_ids=np.tile(slot_ids, (kc, 1)),
        tie_break=tie_break,
        device=dev,
    )
    node_cost = (res.total_cost / scale).reshape(kc, kc)
    with _penalty_span(tracer, cluster):
        pen = _relabel_penalties(
            cluster, down_nodes, occupied_logical, speed_factor
        )
        if pen is not None:
            node_cost = node_cost + pen
    n_rows, n_cols = solve_lap(
        node_cost * scale,
        backend=backend,
        context=context,
        context_key="migration_node",
        row_ids=node_ids,
        col_ids=node_ids,
        tie_break=tie_break,
        device=dev,
    )
    with tracer.span("migrate.assemble"):
        # res.col_of[b, u] = v  ->  gpu_assign[.., v] = u
        gpu_assign = np.argsort(res.col_of, axis=-1).reshape(kc, kc, kl)
        node_assignment = np.empty(kc, dtype=np.int64)
        node_assignment[n_cols] = n_rows  # logical node l -> physical node k

        phys_slots = np.full_like(new_logical.slots, EMPTY)
        for l in range(kc):
            k = node_assignment[l]
            for v in range(kl):
                u = gpu_assign[k, l, v]
                phys_slots[k, u] = new_logical.slots[l, v]
        phys = PlacementPlan(cluster, phys_slots)
        n_mig = count_migrations(prev, phys)
    return MigrationResult(
        phys,
        n_mig,
        float(node_cost[n_rows, n_cols].sum()),
        node_assignment,
        time.perf_counter() - t0,
        algorithm,
    )


def plan_migration_batched_auction(
    prev: PlacementPlan,
    new_logical: PlacementPlan,
    num_gpus_of: Dict[int, int],
    use_kernel: bool = False,
    device=None,
) -> MigrationResult:
    """Beyond-paper: Algorithm 2 with the k_c^2 node-pair LAPs solved as ONE
    batched auction instead of k_c^2 sequential Hungarian calls.

    A thin wrapper over :func:`plan_migration` with the engine's
    ``auction`` backend (``auction_kernel`` routes the bid top-2 through
    the ``lap_bid`` CUDA kernel).  Exactness: costs are multiples of
    ``1/(2*num_gpus)`` and are scaled to integers before solving, so the
    auction's final epsilon guarantees optimality per instance.
    """
    res = plan_migration(
        prev,
        new_logical,
        num_gpus_of,
        algorithm="node",
        backend="auction_kernel" if use_kernel else "auction",
        device=device,
    )
    return dataclasses.replace(res, algorithm="node-auction")
