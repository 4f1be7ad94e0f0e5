"""The Tesserae round scheduler (Listing 1 + Fig. 4).

One ``decide()`` call per scheduling round:

1. sort active jobs by the composed scheduling policy's priority,
2. place as many as possible WITHOUT packing, consolidated (Fig. 5),
3. if GPU sharing is enabled, pack pending jobs onto placed jobs via the
   max-weight bipartite matching of Algorithm 4,
4. compute the migration plan vs. the previous round's physical placement
   (Algorithms 2+3) and emit the physically-relabelled plan.

The per-stage wall times are recorded — they are the Fig. 14(b) overhead
breakdown and the Fig. 2 decision-time measurements.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import ClusterHealth, ClusterSpec, PlacementPlan
from repro_torch.core.jobs import JobState
from repro_torch.core.matching import MatchContext
from repro_torch.core.migration import MigrationResult, plan_migration
from repro_torch.core.packing import PackingResult, pack_jobs
from repro_torch.core.placement import apply_packing, place_without_packing
from repro_torch.core.policies.base import SchedulingPolicy
from repro_torch.core.profiler import ThroughputProfile
from repro_torch.device import resolve_device
from repro_torch.obs.tracer import tracer_of


class DegradeReason:
    """Taxonomy of graceful-degradation steps a round can take (surfaced
    per round through :attr:`RoundDecision.degrade_reason` and aggregated
    into ``SimResult.degrade_rounds``).  The ladder, best to worst:

    ``none`` -> fused served the round -> [``fused-budget`` |
    ``fused-nonconverged``]: host planner served a fused round ->
    ``deadline-host``: the decide() watchdog demoted fused to the host
    planner before starting the migrate stage -> ``deadline-greedy``: the
    watchdog skipped relabelling entirely and emitted the greedy-feasible
    logical plan (``algorithm="none"``) — always valid, zero extra LAPs.

    The port has no fused planner yet, so its rounds take ``none`` or
    ``deadline-greedy``; the names stay so both packages tag alike.
    """

    NONE = "none"
    FUSED_BUDGET = "fused-budget"
    FUSED_NONCONVERGED = "fused-nonconverged"
    DEADLINE_HOST = "deadline-host"
    DEADLINE_GREEDY = "deadline-greedy"

    ALL = (NONE, FUSED_BUDGET, FUSED_NONCONVERGED, DEADLINE_HOST, DEADLINE_GREEDY)


@dataclasses.dataclass
class RoundDecision:
    plan: PlacementPlan  # physical plan for the next round
    placed: List[JobState]
    pending: List[JobState]
    packing: PackingResult
    migration: Optional[MigrationResult]
    timings: Dict[str, float]
    #: this round's delta of the scheduler's MatchContext stats (memo /
    #: warm / cold instances, price invalidations, ...) — the per-round
    #: warm-hit telemetry the churn-replay CI gate and the simulator
    #: aggregate.
    match_stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: which degradation-ladder step (if any) produced this round's plan.
    degrade_reason: str = DegradeReason.NONE

    @property
    def total_overhead_s(self) -> float:
        return sum(self.timings.values())

    @property
    def warm_hits(self) -> int:
        """Instances this round served from the identity-keyed context
        (memoised or price-warm) across all LAP families."""
        return int(self.match_stats.get("warm_instances", 0))


class TesseraeScheduler:
    """Placement policy engine composed with a pluggable scheduling policy."""

    def __init__(
        self,
        cluster: ClusterSpec,
        policy: SchedulingPolicy,
        profile: ThroughputProfile,
        enable_packing: bool = True,
        optimize_strategy: bool = True,
        migration_algorithm: str = "node",  # node | flat | none
        # matching-engine backend for packing + migration LAPs:
        # auto | numpy | scipy | auction | auction_kernel (one knob,
        # dispatched through repro_torch.core.matching.solve_lap[_batched])
        lap_backend: str = "auto",
        packed_ok: Optional[Callable[[JobState, JobState], bool]] = None,
        match_context: Optional[MatchContext] = None,
        # canonical tie-break perturbation on every LAP, so equally-optimal
        # packings/relabellings are solver-independent (bit-for-bit
        # differential testing across backends); off by default — the seed
        # placements are preserved exactly.
        tie_break: bool = False,
        # heterogeneous clusters: type-affinity placement key (sub-node
        # jobs to the slowest sufficient GPU type, gangs to the fastest
        # empty nodes).  No-op on homogeneous clusters.
        type_affinity: bool = True,
        # the fused device-resident migrate stage (core/fused.py with the
        # fused bid kernels) is a later slice of the port: True raises.
        fused_fanout: bool = False,
        fanout_shards: int = 1,
        # graceful-degradation ladder: wall-clock budget for one decide()
        # call.  When the elapsed time at the migrate stage exceeds half
        # the deadline, a fused round is demoted to the host planner; past
        # the full deadline the relabelling is skipped entirely and the
        # greedy-feasible logical plan ships as-is.  None (default)
        # disables the watchdog — the seed behaviour.
        decide_deadline_s: Optional[float] = None,
        # injectable clock for deterministic ladder tests.
        clock: Callable[[], float] = time.perf_counter,
        # failure-aware placement: fold ClusterHealth into the benefit
        # terms — degraded nodes gain the straggler-drain relabel penalty
        # (migration._relabel_penalties, host AND fused paths), and when
        # the observed outage process is hot (empirical per-node MTBF
        # below `spread_mtbf_h` hours) large gangs are spread across
        # failure domains (racks) in placement and prioritised by the
        # policy's spread hook.  Off by default — with the knob off, or
        # with all nodes healthy, decide() is bit-identical to the seed.
        health_aware: bool = False,
        spread_mtbf_h: float = 12.0,
        # opt-in observability bundle (repro_torch.obs.Observability): structured
        # span tracing of the decide() pipeline.  None (default) routes
        # every instrumentation point through no-op singletons — the
        # decision sequence is bit-identical to the uninstrumented path.
        obs=None,
        # where the matching state lives and the kernels run: CUDA unless
        # the caller asks for the CPU; raises when CUDA is asked and absent.
        device=None,
    ):
        if fused_fanout:
            raise NotImplementedError(
                "fused_fanout=True needs the fused migrate stage (core/fused.py "
                "with the lap_bid_fused kernels), which the PyTorch port does "
                "not have yet (ROADMAP.md, section 1)"
            )
        self.device = resolve_device(device)
        self.cluster = cluster
        self.policy = policy
        self.profile = profile
        self.enable_packing = enable_packing
        self.optimize_strategy = optimize_strategy
        self.migration_algorithm = migration_algorithm
        self.lap_backend = lap_backend
        self.packed_ok = packed_ok
        self.tie_break = tie_break
        self.type_affinity = type_affinity
        self.fused_fanout = fused_fanout
        self.fanout_shards = fanout_shards
        self.decide_deadline_s = decide_deadline_s
        self._clock = clock
        self.health_aware = health_aware
        self.spread_mtbf_h = spread_mtbf_h
        #: identity-keyed warm-start state threaded across rounds: the
        #: packing matching (keyed by job ids), the Algorithm-2 node-pair
        #: fan-out (node-pair / GPU-slot ids) and the final node match
        #: (node ids) all keep their auction prices / memoised assignments
        #: here, so a round whose placements barely moved (the common
        #: case, Fig. 2) re-solves only what actually changed — including
        #: under churn, where jobs arriving/finishing change the packing
        #: graph's SHAPE but not the surviving identities.
        self.match_context = (
            match_context
            if match_context is not None
            else MatchContext(device=self.device)
        )
        self.obs = None
        if obs is not None:
            self.set_observability(obs)

    def set_observability(self, obs) -> None:
        """Attach (or detach, with ``None``) an observability bundle to the
        scheduler AND its matching context, so LAP-solve spans nest under
        this scheduler's decide spans."""
        self.obs = obs
        self.match_context.obs = obs

    def decide(
        self,
        active_jobs: Sequence[JobState],
        now: float,
        prev_plan: Optional[PlacementPlan] = None,
        num_gpus_of: Optional[Dict[int, int]] = None,
        health: Optional[ClusterHealth] = None,
    ) -> RoundDecision:
        tracer = tracer_of(self.obs)
        with tracer.span("decide", jobs=len(active_jobs)) as sp:
            decision = self._decide_impl(
                active_jobs, now, prev_plan, num_gpus_of, health, tracer
            )
            sp.annotate(
                placed=len(decision.placed),
                pending=len(decision.pending),
                degrade=decision.degrade_reason,
                warm_instances=decision.warm_hits,
            )
        return decision

    def _decide_impl(
        self,
        active_jobs: Sequence[JobState],
        now: float,
        prev_plan: Optional[PlacementPlan],
        num_gpus_of: Optional[Dict[int, int]],
        health: Optional[ClusterHealth],
        tracer,
    ) -> RoundDecision:
        timings: Dict[str, float] = {}
        stats_before = dict(self.match_context.stats)
        degrade = DegradeReason.NONE
        # down nodes are ZERO capacity everywhere below; None (all up, or
        # no health tracking) keeps every stage on the seed code path
        down: Optional[np.ndarray] = None
        if health is not None and not health.all_up:
            down = health.down_nodes()
        # failure-aware terms (all None/False unless the knob is on AND the
        # health object carries real signal — the seed path is untouched):
        # `speed` feeds the straggler-drain relabel penalty, `spread`
        # switches gang placement to breadth-first across racks, and the
        # policy's spread hook (if it has one) boosts large gangs so the
        # spread actually gets first pick of the empty nodes.
        speed: Optional[np.ndarray] = None
        spread = False
        if self.health_aware and health is not None:
            if health.degraded:
                speed = health.speed_factor
            hot = health.hazard_hot(now, self.spread_mtbf_h * 3600.0)
            spread = hot and self.cluster.has_topology
            if hasattr(self.policy, "set_spread_hot"):
                self.policy.set_spread_hot(hot)

        t_start = self._clock()
        t0 = time.perf_counter()
        with tracer.span("policy_sort", policy=type(self.policy).__name__):
            ordered = self.policy.order(active_jobs, now, self.cluster)
        timings["schedule_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with tracer.span("place", spread=spread) as sp_place:
            plan, placed, pending = place_without_packing(
                self.cluster,
                ordered,
                type_affinity=self.type_affinity,
                down_nodes=down,
                spread_domains=spread,
            )
            sp_place.annotate(placed=len(placed), pending=len(pending))
        timings["place_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with tracer.span("pack", enabled=self.enable_packing) as sp_pack:
            if self.enable_packing:
                placed_types = None
                if self.cluster.node_gpu_types is not None and placed:
                    # heterogeneous cluster: each placed job's packing
                    # weights (incl. HBM feasibility) are profiled on its
                    # node's type
                    gmap_placed = plan.job_gpu_map()
                    placed_types = [
                        self.cluster.gpu_type_of(
                            self.cluster.node_of(min(gmap_placed[j.job_id]))
                        )
                        for j in placed
                    ]
                packing = pack_jobs(
                    placed,
                    pending,
                    self.profile,
                    optimize_strategy=self.optimize_strategy,
                    backend=self.lap_backend,
                    packed_ok=self.packed_ok,
                    context=self.match_context,
                    placed_gpu_types=placed_types,
                    tie_break=self.tie_break,
                )
                if packing.matches:
                    placed_lookup = {j.job_id: j for j in placed}
                    plan = apply_packing(plan, packing.matches, placed_lookup)
            else:
                packing = PackingResult({}, {}, 0.0, 0.0, 0)
            sp_pack.annotate(matches=len(packing.matches))
        timings["pack_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        migration: Optional[MigrationResult] = None
        if prev_plan is not None:
            gmap: Dict[int, int] = dict(num_gpus_of or {})
            for j in active_jobs:
                gmap.setdefault(j.job_id, j.num_gpus)
            # --- degradation-ladder watchdog (wall clock, injectable) ---- #
            deadline = self.decide_deadline_s
            elapsed = self._clock() - t_start if deadline is not None else 0.0
            algorithm = self.migration_algorithm
            if deadline is not None and elapsed >= deadline:
                # past the full budget: skip relabelling, ship the
                # greedy-feasible logical plan (already avoids down nodes)
                algorithm = "none"
                degrade = DegradeReason.DEADLINE_GREEDY
            with tracer.span("migrate.host", algorithm=algorithm) as sp_mig:
                migration = plan_migration(
                    prev_plan,
                    plan,
                    gmap,
                    algorithm=algorithm,
                    backend=self.lap_backend,
                    context=self.match_context,
                    tie_break=self.tie_break,
                    down_nodes=down,
                    speed_factor=speed,
                    device=self.device,
                )
                sp_mig.annotate(migrations=migration.num_migrations)
            plan = migration.physical_plan
        timings["migrate_s"] = time.perf_counter() - t0

        match_stats = {
            k: v - stats_before.get(k, 0)
            for k, v in self.match_context.stats.items()
            if v != stats_before.get(k, 0)
        }
        return RoundDecision(
            plan,
            placed,
            pending,
            packing,
            migration,
            timings,
            match_stats,
            degrade_reason=degrade,
        )

    def invalidate_node(self, node: int) -> int:
        """TARGETED warm-state invalidation for one physical node (called
        by the simulator on node-down AND node-up events): every cached
        matching identity involving the node is poisoned — the Algorithm-2
        fan-out pairs touching it and the single-instance node match and
        flat families — while all other nodes' memo/warm state survives (the paper's
        temporal locality is exactly why a full reset would be wasteful).
        Returns the number of cached LAP instances invalidated.
        """
        kc = self.cluster.num_nodes
        ids = np.arange(kc, dtype=np.int64)
        # fan-out instance ids are i * 2^20 + j (migration.plan_migration)
        pair_ids = np.concatenate([node * (1 << 20) + ids, ids * (1 << 20) + node])
        count = self.match_context.invalidate_instances(
            np.unique(pair_ids), families=("migration_pairs",)
        )
        # the node match and the flat relabelling are single-instance
        # families (default instance id 0) — any node fault perturbs them
        count += self.match_context.invalidate_instances(
            [0], families=("migration_node", "migration_flat")
        )
        return count

    def prewarm(
        self,
        active_jobs: Sequence[JobState],
        now: float,
        prev_plan: Optional[PlacementPlan] = None,
        num_gpus_of: Optional[Dict[int, int]] = None,
    ) -> None:
        """Speculatively run next round's decision pipeline to warm
        :attr:`match_context`.

        The result is discarded — only the side effect matters: the
        expected node-pair fan-out, final node match and packing LAPs are
        solved through the context NOW (in a real deployment, during the
        scheduler's idle time between rounds), so when ``decide`` runs for
        real with (mostly) the same inputs it memo-hits or warm-starts and
        its critical-path wall time collapses.  Speculation is always
        safe: a wrong guess only leaves non-matching fingerprints behind.
        """
        self.decide(active_jobs, now, prev_plan, num_gpus_of)


def tiresias_single_packed_ok(u: JobState, v: JobState) -> bool:
    """Tiresias (Single) baseline: only pack 1-GPU jobs (Lucid/Pollux rule —
    'at most one distributed job per node', so distributed jobs never
    share)."""
    return u.num_gpus == 1 and v.num_gpus == 1


# vectorised fast path used by build_packing_graph on large rounds
tiresias_single_packed_ok.vectorized_on_gpus = True
tiresias_single_packed_ok.gpu_mask = lambda gi, gj: (gi[:, None] == 1) & (
    gj[None, :] == 1
)
