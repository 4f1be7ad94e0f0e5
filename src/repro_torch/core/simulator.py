"""Round-based discrete-event simulator (§5 "Schedulers", §6.2).

The paper validates its simulator against a 32-GPU Perlmutter cluster
(Table 2, max deviation 5.42%) and then runs all large-scale comparisons in
simulation; we inherit that methodology.  Semantics:

* scheduling happens every ``round_duration_s`` (six minutes, §5);
* within a round a job progresses at
  ``isolated_tput(model, gpus, strategy) * packed_factor`` iters/sec,
* a migrated job first pays its migration debt (checkpoint save + load +
  warmup, Fig. 3) before making progress; a *newly started* job pays the
  ``startup_fraction`` of the debt (warmup / initial load only) and a
  *resumed* (previously preempted) job pays ``resume_fraction`` —
  defaulting to the same value, the paper's Fig. 3 model,
* jobs finishing mid-round release GPUs only at the next round boundary
  (round-based semantics; Tesserae "only preempts the job after the job
  finishes the current iteration").

Throughput truth vs. belief: the scheduler consults ``sched_profile``
(possibly noisy / estimated, Figs. 16 & 18) while the simulator advances
jobs with ``true_profile``.

**Fault injection** (:mod:`repro_torch.core.faults`): an optional event stream
drives node-down / node-up / gpu-degrade / job-fail events, applied at
round boundaries.  A node-down evicts every job touching the node WITHOUT
a checkpoint save — progress rolls back to the last checkpoint (the
checkpoint-interval lost-work model), a retry is consumed and the job
re-enters the queue after an exponential backoff; a job that exhausts its
retry budget fails terminally.  Voluntary preemptions and migrations DO
checkpoint (the scheduler drains gracefully), so only genuine crashes
lose work.  GPU degradations slow the job's real rate to the slowest
touched node's ``speed_factor``; a health-BLIND scheduler's beliefs are
unchanged (an undetected straggler), while a health-aware one
(``health_aware=True``) sees the speed factors and drains jobs off
degraded nodes through the relabelling benefit.  With no failure events
every fault code path is inert and the simulation is bit-identical to
the failure-free seed.

**Crash-resume**: ``run(stop_after_rounds=k)`` pauses the loop with all
round state retained; :meth:`Simulator.save_state` /
:meth:`Simulator.load_state` serialise it (one versioned ``.npz``,
embedding the scheduler's :class:`MatchContext` warm state), and a
resumed run finishes bit-identical to an uninterrupted one.  Policy
objects with internal state (Gavel's LP refresh) are NOT captured — use
stateless policies (Tesserae, Tiresias) when snapshotting.
"""

from __future__ import annotations

import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import ClusterHealth, ClusterSpec, PlacementPlan
from repro_torch.core.faults import (
    GPU_DEGRADE,
    JOB_FAIL,
    NODE_DOWN,
    NODE_UP,
    FailureEvent,
)
from repro_torch.core.jobs import JobSpec, JobState, migration_overhead_s
from repro_torch.core.matching import MatchContext
from repro_torch.core.policies.base import SchedulingPolicy
from repro_torch.core.policies.gavel import GavelPolicy
from repro_torch.core.policies.themis import ThemisFtfPolicy
from repro_torch.core.profiler import GPU_TYPES, ThroughputProfile
from repro_torch.core.scheduler import RoundDecision, TesseraeScheduler
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import tracer_of


@dataclasses.dataclass
class SimConfig:
    round_duration_s: float = 360.0
    max_time_s: float = 60 * 24 * 3600.0
    migration_penalty: bool = True
    #: fraction of the migration debt charged on a COLD start (a job's
    #: first placement ever: warmup + initial load, no checkpoint to read)
    startup_fraction: float = 0.5
    #: fraction charged on a RESUME (a preempted job returning to GPUs:
    #: checkpoint load + warmup).  ``None`` = same as ``startup_fraction``
    #: — the paper's Fig. 3 model, and the seed behaviour.
    resume_fraction: Optional[float] = None
    #: speculatively run the next round's decision pipeline after each
    #: round (the simulator knows the exact next active set once the round
    #: has advanced), so the scheduler's :class:`MatchContext` is warm and
    #: the *measured* ``decide()`` critical path collapses to memo/warm
    #: hits.  Models a production scheduler using its idle time between
    #: rounds; off by default so seed timings stay comparable.  The
    #: speculation runs on a background thread that is joined before the
    #: next ``decide`` touches the scheduler, so the sim loop no longer
    #: pays the 2x serial decide work (overlap is reported in
    #: :attr:`SimResult.prewarm_overlap_s`).
    speculative_prewarm: bool = False
    # -- fault-model knobs (all inert without failure events) ------------- #
    #: retries a job may consume (node crashes + software failures both
    #: count) before it fails terminally.
    max_retries: int = 5
    #: backoff before a failed job is eligible again:
    #: ``backoff_base_s * backoff_factor ** (retries - 1)``.
    backoff_base_s: float = 360.0
    backoff_factor: float = 2.0
    #: periodic checkpoint cadence (seconds of EXECUTED time); a crash
    #: rolls progress back to the last checkpoint.  Voluntary migrations
    #: and graceful preemptions always checkpoint first.
    checkpoint_interval_s: float = 1800.0
    #: adapt the periodic cadence per job against the lost-work integral:
    #: once the outage process has been observed (``ClusterHealth``'s
    #: empirical MTBF exists), each job checkpoints at Young's interval
    #: ``sqrt(2 * delta * MTBF_job)`` where ``delta`` is half the job's
    #: migration overhead and ``MTBF_job`` the pooled per-node MTBF divided
    #: by the nodes the job spans (any node failing kills the gang).  The
    #: result is clamped to ``[round_duration_s, checkpoint_interval_s]``
    #: — the sim charges no checkpoint-write cost, so the lower clamp is
    #: what bounds the cadence's aggressiveness.  Off by default (the seed
    #: fixed-interval behaviour).
    adaptive_checkpoint: bool = False


@dataclasses.dataclass
class SimResult:
    jobs: Dict[int, JobState]
    makespan_s: float
    num_rounds: int
    total_migrations: int
    #: per-round scheduler overhead breakdown (schedule/place/pack/migrate)
    overhead: Dict[str, float]
    lp_refresh_s: float
    contention_integral: Dict[int, float]  # job_id -> avg demand/capacity
    #: per-round MatchContext stat deltas (memo/warm/cold instances, price
    #: invalidations) — the identity-keyed warm-start telemetry the churn
    #: replay tests and the CI perf-smoke gate read.
    match_rounds: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    #: total wall time the speculative-prewarm thread spent deciding, and
    #: the portion of it that OVERLAPPED the main sim loop (prewarm wall
    #: minus the time the loop actually blocked waiting for it) — both 0.0
    #: when ``speculative_prewarm`` is off.
    prewarm_wall_s: float = 0.0
    prewarm_overlap_s: float = 0.0
    # -- fault / degradation telemetry ------------------------------------ #
    #: per-round ``DegradeReason`` tags (same length as ``match_rounds``).
    degrade_rounds: List[str] = dataclasses.field(default_factory=list)
    #: involuntary evictions (node-down preemptions) across all jobs.
    preemptions: int = 0
    #: retries consumed across all jobs (crashes + software failures).
    retries_total: int = 0
    #: iterations discarded by crash rollbacks (the lost-work integral).
    lost_iters_total: float = 0.0
    #: jobs that exhausted their retry budget (terminal failures).
    failed_jobs: List[int] = dataclasses.field(default_factory=list)
    #: failure-model events actually applied during the run.
    fault_events_applied: int = 0
    #: seconds of executed time discarded by crash rollbacks (the
    #: lost-work integral the adaptive checkpoint cadence minimises).
    lost_work_s_total: float = 0.0
    #: voluntary migrations that moved a job OFF a degraded node onto
    #: strictly faster ones — the straggler-drain relabel penalty at work.
    drain_migrations: int = 0
    #: the run's metrics registry (repro_torch.obs) — the single aggregation
    #: substrate the simulator records per-round telemetry into.  The
    #: legacy aggregate properties below (``fused_host_fallbacks``,
    #: ``degrade_counts``, ``warm_hit_rounds``, ``total_bid_iters``) are
    #: views over it; per-round detail stays on ``match_rounds`` /
    #: ``degrade_rounds``.
    metrics: MetricsRegistry = dataclasses.field(default_factory=MetricsRegistry)

    @property
    def jcts(self) -> np.ndarray:
        return np.array(
            [s.finish_time - s.spec.arrival_time for s in self.jobs.values()]
        )

    @property
    def avg_jct_s(self) -> float:
        return float(self.jcts.mean())

    @property
    def fused_host_fallbacks(self) -> int:
        """Rounds the fused migrate stage served from the host planner
        (mantissa-budget overflow or non-converged auction)."""
        return self.metrics.counter_value("match.fused_host_fallbacks")

    @property
    def degrade_counts(self) -> Dict[str, int]:
        """Histogram of per-round degradation-ladder steps (``"none"``
        rounds included)."""
        return self.metrics.counters_with_prefix("sim.degrade.")

    def ftf_ratios(self, profile: ThroughputProfile) -> np.ndarray:
        """rho = T_shared / T_fair; T_fair = isolated duration stretched by
        the average demand/capacity contention over the job's lifetime."""
        out = []
        for jid, s in self.jobs.items():
            tput = profile.isolated(s.spec.model, s.num_gpus, "dp")
            iso = s.spec.total_iters / max(tput, 1e-9)
            contention = max(1.0, self.contention_integral.get(jid, 1.0))
            t_fair = iso * contention
            t_shared = s.finish_time - s.spec.arrival_time
            out.append(t_shared / max(t_fair, 1e-9))
        return np.array(out)

    def summary(self, profile: Optional[ThroughputProfile] = None) -> Dict[str, float]:
        d = {
            "avg_jct_s": self.avg_jct_s,
            "p50_jct_s": float(np.median(self.jcts)),
            "p90_jct_s": float(np.percentile(self.jcts, 90)),
            "makespan_s": self.makespan_s,
            "migrations": float(self.total_migrations),
            "rounds": float(self.num_rounds),
            "overhead_total_s": float(sum(self.overhead.values())) + self.lp_refresh_s,
        }
        if profile is not None:
            rho = self.ftf_ratios(profile)
            d["ftf_worst"] = float(rho.max())
            d["ftf_p90"] = float(np.percentile(rho, 90))
        lat = self.metrics.histogram_values("decide.latency_s")
        if lat:
            # SLO telemetry for the online-serving arc: exact nearest-rank
            # percentiles of per-round decide() wall time
            h = self.metrics.histogram("decide.latency_s")
            d["decide_p50_s"] = h.percentile(50)
            d["decide_p99_s"] = h.percentile(99)
        return d

    def warm_hit_rounds(self, skip: int = 1) -> int:
        """Rounds (after the first ``skip`` warmup rounds) in which the
        scheduler served at least one LAP instance from its identity-keyed
        context — the churn-replay acceptance metric."""
        warm = self.metrics.histogram_values("match.warm_instances_per_round")
        return sum(1 for v in warm[skip:] if v > 0)

    @property
    def total_bid_iters(self) -> int:
        """Not tracked per round by the scheduler timings — derived from
        the context stats the rounds accumulated (0 when the backend is
        exact)."""
        return self.metrics.counter_value("match.bid_iters")


@dataclasses.dataclass
class _SimState:
    """The whole between-rounds loop state — one object so stop/resume
    and the crash snapshot have a single thing to carry."""

    states: Dict[int, JobState]
    num_gpus_of: Dict[int, int]
    health: ClusterHealth
    now: float = 0.0
    rounds: int = 0
    prev_plan: Optional[PlacementPlan] = None
    prev_gpus: Dict[int, frozenset] = dataclasses.field(default_factory=dict)
    total_migrations: int = 0
    match_rounds: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    overhead: Dict[str, float] = dataclasses.field(default_factory=dict)
    lp_refresh_s: float = 0.0
    contention_num: Dict[int, float] = dataclasses.field(default_factory=dict)
    contention_den: Dict[int, float] = dataclasses.field(default_factory=dict)
    degrade_rounds: List[str] = dataclasses.field(default_factory=list)
    event_idx: int = 0
    events_applied: int = 0
    preemptions: int = 0
    retries_total: int = 0
    lost_iters: float = 0.0
    lost_work_s: float = 0.0
    drain_migrations: int = 0
    failed_jobs: List[int] = dataclasses.field(default_factory=list)
    prewarm_wall: float = 0.0
    prewarm_overlap: float = 0.0
    # -- the live-job index (derived from ``states`` and ``now``; never
    # snapshotted, rebuilt by ``load_state``) so a round visits the jobs
    # that can act, not the whole trace --------------------------------- #
    #: position in the simulator's sorted trace of the first job not yet
    #: admitted to ``live``.
    cursor: int = 0
    #: arrived, unfinished jobs in trace order (the order of ``states``).
    live: Dict[int, JobState] = dataclasses.field(default_factory=dict)
    #: ids of the live jobs whose ``gpus`` is not empty.
    holders: set = dataclasses.field(default_factory=set)


#: version tag of the simulator round-state snapshot format.  v2 adds the
#: per-job ``ckpt_service`` field (crash-accounting fix: LAS service is
#: rewound with the checkpoint) plus the outage counter and drain/lost-work
#: telemetry.
SIM_STATE_VERSION = "tesserae-simstate-v2"

#: JobState fields the snapshot round-trips (spec fields come from the
#: trace the resuming simulator is constructed with).
_JOB_STATE_FIELDS = (
    "iters_done",
    "attained_service",
    "executed_time",
    "first_run_time",
    "finish_time",
    "packed_with",
    "strategy",
    "migrations",
    "migration_debt",
    "retries",
    "preemptions",
    "eligible_time",
    "ckpt_iters",
    "ckpt_executed",
    "ckpt_service",
    "lost_iters",
    "failed",
)


class Simulator:
    def __init__(
        self,
        cluster: ClusterSpec,
        trace: Sequence[JobSpec],
        scheduler: TesseraeScheduler,
        true_profile: ThroughputProfile,
        config: SimConfig | None = None,
        failures: Optional[Sequence[FailureEvent]] = None,
        round_hook=None,
        obs=None,
    ):
        self.cluster = cluster
        self.trace = sorted(trace, key=lambda s: (s.arrival_time, s.job_id))
        self.scheduler = scheduler
        self.true_profile = true_profile
        self.config = config or SimConfig()
        events = sorted(failures or [], key=FailureEvent.sort_key)
        for ev in events:
            if ev.node is not None and not (0 <= ev.node < cluster.num_nodes):
                raise ValueError(
                    f"failure event targets node {ev.node}, cluster has "
                    f"{cluster.num_nodes} nodes"
                )
        self._events: List[FailureEvent] = events
        #: optional per-round callback
        #: ``hook(round_idx, now, decision, states, health)`` invoked after
        #: the round advanced — the chaos suite asserts its safety
        #: invariants here.
        self.round_hook = round_hook
        #: in-progress loop state (``run(stop_after_rounds=...)`` retains
        #: it for :meth:`save_state` / a continued :meth:`run` call).
        self._state: Optional[_SimState] = None
        #: opt-in observability bundle (repro_torch.obs.Observability): span
        #: tracing of the round loop + the scheduler pipeline.  ``None``
        #: (default) keeps every decision code path bit-identical to the
        #: uninstrumented one.  The METRICS registry is always on — it is
        #: pure host-side aggregation of numbers the loop already computes,
        #: and ``SimResult``'s telemetry views read from it.
        self.obs = obs
        if obs is not None and hasattr(scheduler, "set_observability"):
            scheduler.set_observability(obs)
        self._metrics: MetricsRegistry = (
            obs.metrics if obs is not None else MetricsRegistry()
        )

    # ------------------------------------------------------------------ #
    def run(self, stop_after_rounds: Optional[int] = None) -> Optional[SimResult]:
        """Run (or continue) the simulation.

        Returns the :class:`SimResult` when the workload completes.  With
        ``stop_after_rounds=k`` the loop pauses after the k-th round of
        THIS call and returns ``None`` — all state stays on the simulator
        (snapshot it with :meth:`save_state`, or call :meth:`run` again to
        continue).
        """
        cfg = self.config
        tracer = tracer_of(self.obs)
        if self._state is None:
            if self.obs is None:
                # fresh run, internal registry: start clean so a reused
                # Simulator object never double-counts (the previous
                # SimResult keeps its own registry reference)
                self._metrics = MetricsRegistry()
            self._state = _SimState(
                states={s.job_id: JobState(spec=s) for s in self.trace},
                num_gpus_of={s.job_id: s.num_gpus for s in self.trace},
                health=ClusterHealth(self.cluster.num_nodes),
            )
        st = self._state
        rounds_this_call = 0
        executor: Optional[ThreadPoolExecutor] = None
        pending_prewarm = None
        if cfg.speculative_prewarm:
            executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sim-prewarm"
            )

        def _timed_prewarm(spec_active, t, plan, gmap):
            t0 = time.perf_counter()
            # traces into the prewarm thread's own root list (the tracer
            # keeps per-thread span stacks), so speculative decides never
            # nest under the measured round's spans
            with tracer.span("prewarm", jobs=len(spec_active)):
                self.scheduler.prewarm(spec_active, t, plan, gmap)
            return time.perf_counter() - t0

        try:
            while st.now < cfg.max_time_s:
                # the prewarm thread owns the scheduler (MatchContext and
                # policy state) until joined — block before anything below
                # touches it.  Join wait below the prewarm's own wall time
                # is loop work the speculation overlapped with.
                if pending_prewarm is not None:
                    t_join = time.perf_counter()
                    w = pending_prewarm.result()
                    waited = time.perf_counter() - t_join
                    st.prewarm_wall += w
                    st.prewarm_overlap += max(0.0, w - waited)
                    pending_prewarm = None

                self._apply_events(st)

                with tracer.span("sim.scan") as sp_scan:
                    active = self._scan_active(st)
                    sp_scan.annotate(live=len(st.live))
                if not st.live and st.cursor == len(self.trace):
                    break
                if not active:
                    # idle until the next arrival's (or backoff expiry's)
                    # round boundary; fault events in the skipped window
                    # are applied at the next loop top.  Every live job is
                    # in backoff; a job not yet admitted never ran, so its
                    # arrival is its boundary, and the cursor's is the least
                    waits = [s.eligible_time for s in st.live.values()]
                    if st.cursor < len(self.trace):
                        waits.append(self.trace[st.cursor].arrival_time)
                    next_t = min(waits)
                    k = int(np.floor(next_t / cfg.round_duration_s))
                    now_new = max(
                        st.now + cfg.round_duration_s, k * cfg.round_duration_s
                    )
                    # never skip past a pending fault event's boundary
                    if st.event_idx < len(self._events):
                        ev_t = self._events[st.event_idx].time_s
                        ke = int(np.ceil(ev_t / cfg.round_duration_s))
                        now_new = min(
                            now_new,
                            max(
                                st.now + cfg.round_duration_s,
                                ke * cfg.round_duration_s,
                            ),
                        )
                    st.now = now_new
                    continue

                # LP-based policies re-solve their optimisation once per round.
                if isinstance(self.scheduler.policy, GavelPolicy):
                    st.lp_refresh_s += self.scheduler.policy.refresh(
                        active, self.cluster
                    )
                if isinstance(self.scheduler.policy, ThemisFtfPolicy):
                    demand = sum(j.num_gpus for j in active)
                    self.scheduler.policy.avg_contention = max(
                        1.0, demand / self.cluster.num_gpus
                    )

                # Only pass health when it carries signal the scheduler
                # can act on: a node down (any scheduler routes around
                # it), or — for health-AWARE schedulers only — degraded
                # speeds (straggler drain) / an observed outage history
                # (MTBF hazard for domain spread, which must stay visible
                # after nodes recover).  decide() treats an all-up,
                # full-speed health identically to None (tested), and
                # omitting the kwarg keeps pre-fault decide() overrides
                # (e.g. differential-shadow schedulers) working unchanged.
                health_signal = not st.health.all_up or (
                    getattr(self.scheduler, "health_aware", False)
                    and (st.health.degraded or st.health.outages > 0)
                )
                with tracer.span(
                    "round", index=st.rounds, active=len(active)
                ) as sp_round:
                    if st.health is not None and health_signal:
                        decision = self.scheduler.decide(
                            active,
                            st.now,
                            st.prev_plan,
                            st.num_gpus_of,
                            health=st.health,
                        )
                    else:
                        decision = self.scheduler.decide(
                            active, st.now, st.prev_plan, st.num_gpus_of
                        )
                    st.match_rounds.append(dict(decision.match_stats))
                    st.degrade_rounds.append(decision.degrade_reason)
                    self._record_round_metrics(decision)
                    for k, v in decision.timings.items():
                        st.overhead[k] = st.overhead.get(k, 0.0) + v
                    if decision.migration is not None:
                        st.total_migrations += decision.migration.num_migrations
                    if isinstance(self.scheduler.policy, GavelPolicy):
                        self.scheduler.policy.note_round(
                            [j.job_id for j in decision.placed]
                        )

                    self._advance_round(decision, st)
                    sp_round.annotate(degrade=decision.degrade_reason)

                with tracer.span("sim.handover"):
                    plan_map = decision.plan.job_gpu_map()
                    st.prev_gpus = dict(plan_map)
                    st.prev_plan = decision.plan.restricted_to(
                        [j for j in plan_map if not st.states[j].finished]
                    )
                st.now += cfg.round_duration_s
                st.rounds += 1
                rounds_this_call += 1

                if self.round_hook is not None:
                    with tracer.span("sim.hook"):
                        self.round_hook(
                            st.rounds, st.now, decision, st.states, st.health
                        )

                if executor is not None:
                    # The round has advanced, so the NEXT round's active
                    # set is known exactly; batch its expected LAP
                    # fan-outs through the engine on the prewarm thread
                    # (in production: the scheduler's idle time between
                    # rounds) so the next decide() memo/warm-hits.
                    # Purely a cache side effect — decisions are
                    # unaffected.  The FTF bookkeeping below overlaps it.
                    spec_active = self._scan_active(st)
                    if spec_active:
                        pending_prewarm = executor.submit(
                            _timed_prewarm,
                            spec_active,
                            st.now,
                            st.prev_plan,
                            st.num_gpus_of,
                        )

                # contention bookkeeping for FTF
                with tracer.span("sim.contention"):
                    demand = sum(j.num_gpus for j in active)
                    ratio = demand / self.cluster.num_gpus
                    for j in active:
                        st.contention_num[j.job_id] = (
                            st.contention_num.get(j.job_id, 0.0) + ratio
                        )
                        st.contention_den[j.job_id] = (
                            st.contention_den.get(j.job_id, 0.0) + 1.0
                        )

                if (
                    stop_after_rounds is not None
                    and rounds_this_call >= stop_after_rounds
                ):
                    return None  # paused: state retained on self._state
        finally:
            if pending_prewarm is not None:
                st.prewarm_wall += pending_prewarm.result()
            if executor is not None:
                executor.shutdown(wait=True)

        # should not happen with max_time high enough: the live jobs and
        # those yet to be admitted (none of which ever ran)
        unfinished = list(st.live.values()) + [
            st.states[s.job_id] for s in self.trace[st.cursor:]
        ]
        for s in unfinished:
            s.finish_time = cfg.max_time_s
        st.live.clear()
        st.holders.clear()
        makespan = max((s.finish_time for s in st.states.values()), default=0.0)
        contention = {
            j: st.contention_num[j] / st.contention_den[j]
            for j in st.contention_num
            if st.contention_den.get(j)
        }
        result = SimResult(
            st.states,
            makespan,
            st.rounds,
            st.total_migrations,
            st.overhead,
            st.lp_refresh_s,
            contention,
            st.match_rounds,
            prewarm_wall_s=st.prewarm_wall,
            prewarm_overlap_s=st.prewarm_overlap,
            degrade_rounds=st.degrade_rounds,
            preemptions=st.preemptions,
            retries_total=st.retries_total,
            lost_iters_total=st.lost_iters,
            failed_jobs=list(st.failed_jobs),
            fault_events_applied=st.events_applied,
            lost_work_s_total=st.lost_work_s,
            drain_migrations=st.drain_migrations,
            metrics=self._metrics,
        )
        self._state = None
        return result

    def _scan_active(self, st: _SimState) -> List[JobState]:
        """Admit the jobs that have arrived by ``st.now`` to the live index,
        then return the live jobs out of backoff, in trace order (the
        order of ``st.states``)."""
        trace, now = self.trace, st.now
        while st.cursor < len(trace) and trace[st.cursor].arrival_time <= now:
            s = st.states[trace[st.cursor].job_id]
            if not s.finished:
                st.live[s.job_id] = s
            st.cursor += 1
        return [s for s in st.live.values() if s.eligible_time <= now]

    # ------------------------------------------------------------------ #
    # Metrics recording (host-side aggregation; always on, decision-inert)
    # ------------------------------------------------------------------ #
    def _record_round_metrics(self, decision: RoundDecision) -> None:
        """Fold one measured round into the registry.  Only numbers the
        loop already holds on the host — no device reads, no decision
        inputs touched.  ``match_stats`` keys land as ``match.*`` counters
        (so ``SimResult``'s views re-derive the legacy aggregates), the
        per-round warm/bid-iter series and the stage wall times as exact
        histograms."""
        m = self._metrics
        m.counter("sim.rounds").inc()
        m.counter("sim.degrade." + decision.degrade_reason).inc()
        for k, v in decision.match_stats.items():
            m.counter("match." + k).inc(int(v))
        m.histogram("match.warm_instances_per_round").observe(
            float(decision.match_stats.get("warm_instances", 0))
        )
        m.histogram("match.bid_iters_per_round").observe(
            float(
                decision.match_stats.get("bid_iters", 0)
                + decision.match_stats.get("fused_bid_iters", 0)
            )
        )
        m.histogram("decide.latency_s").observe(
            decision.total_overhead_s
        )
        for k, v in decision.timings.items():
            m.histogram("decide.stage." + k).observe(v)

    def _reseed_metrics(self, st: _SimState) -> None:
        """Rebuild the registry's deterministic content from a restored
        snapshot so a resumed run's counters/histograms finish equal to an
        uninterrupted run's.  Wall-clock (timing) histograms are NOT
        reconstructed — timings were never part of bit-identity.  Guarded
        increments mirror the live recording paths exactly: an instrument
        the live run never touched must not exist after a reseed either."""
        m = self._metrics
        if st.match_rounds:
            m.counter("sim.rounds").inc(len(st.match_rounds))
        for rs in st.match_rounds:
            for k, v in rs.items():
                m.counter("match." + k).inc(int(v))
            m.histogram("match.warm_instances_per_round").observe(
                float(rs.get("warm_instances", 0))
            )
            m.histogram("match.bid_iters_per_round").observe(
                float(rs.get("bid_iters", 0) + rs.get("fused_bid_iters", 0))
            )
        for reason in st.degrade_rounds:
            m.counter("sim.degrade." + reason).inc()
        if st.events_applied:
            m.counter("faults.events_applied").inc(st.events_applied)
        if st.preemptions:
            m.counter("faults.preemptions").inc(st.preemptions)
        if st.retries_total:
            m.counter("faults.retries").inc(st.retries_total)
            m.gauge("faults.lost_iters").set(st.lost_iters)
            m.gauge("faults.lost_work_s").set(st.lost_work_s)
        if st.failed_jobs:
            m.counter("faults.failed_jobs").inc(len(st.failed_jobs))

    # ------------------------------------------------------------------ #
    # Fault-event application (round boundaries)
    # ------------------------------------------------------------------ #
    def _apply_events(self, st: _SimState) -> None:
        if not (
            st.event_idx < len(self._events)
            and self._events[st.event_idx].time_s <= st.now
        ):
            return
        with tracer_of(self.obs).span("apply_events") as sp:
            n0 = st.events_applied
            self._apply_events_impl(st)
            applied = st.events_applied - n0
            sp.annotate(applied=applied)
        self._metrics.counter("faults.events_applied").inc(applied)

    def _apply_events_impl(self, st: _SimState) -> None:
        while (
            st.event_idx < len(self._events)
            and self._events[st.event_idx].time_s <= st.now
        ):
            ev = self._events[st.event_idx]
            st.event_idx += 1
            st.events_applied += 1
            if ev.kind == NODE_DOWN:
                if st.health.up[ev.node]:
                    st.health.up[ev.node] = False
                    st.health.speed_factor[ev.node] = 1.0
                    st.health.note_outage()
                    self._evict_node(st, ev.node)
                    self.scheduler.invalidate_node(ev.node)
            elif ev.kind == NODE_UP:
                if not st.health.up[ev.node]:
                    st.health.up[ev.node] = True
                    st.health.speed_factor[ev.node] = 1.0
                    # the node returns empty: its cached occupancy rows are
                    # stale the moment placement starts using it again
                    self.scheduler.invalidate_node(ev.node)
            elif ev.kind == GPU_DEGRADE:
                if st.health.up[ev.node] and st.health.speed_factor[
                    ev.node
                ] != float(ev.factor):
                    st.health.speed_factor[ev.node] = float(ev.factor)
                    # health-aware benefits fold the speed factor into the
                    # relabel penalties, so the node's cached matching
                    # identities (and fused occupancy rows) are stale the
                    # same way a down/up transition makes them — route
                    # degrades AND recoveries (factor back to 1.0) through
                    # the same targeted invalidation; untouched nodes'
                    # warm state survives
                    self.scheduler.invalidate_node(ev.node)
            elif ev.kind == JOB_FAIL:
                s = st.states.get(ev.job_id)
                # only a RUNNING job can crash; a queued/done job is
                # unaffected (the hazard missed)
                if s is not None and not s.finished and s.gpus:
                    self._crash_job(st, s, preempt=False)

    def _evict_node(self, st: _SimState, node: int) -> None:
        """Node-down: every job with at least one GPU on the node crashes
        (no checkpoint save — gang-synchronous training dies whole).  Only
        live jobs hold GPUs; the victims crash in trace order."""
        victims = [
            s
            for s in st.live.values()
            if s.gpus and any(self.cluster.node_of(g) == node for g in s.gpus)
        ]
        for s in victims:
            self._crash_job(st, s, preempt=True)

    def _crash_job(self, st: _SimState, s: JobState, preempt: bool) -> None:
        cfg = self.config
        lost = max(0.0, s.iters_done - s.ckpt_iters)
        s.iters_done = s.ckpt_iters
        s.lost_iters += lost
        st.lost_iters += lost
        # the lost work is gone from EVERY progress metric, not just
        # iters_done: un-rewound, Tiresias' LAS queues would charge the
        # crash victim for service it no longer has (demoting it behind
        # never-crashed peers with identical surviving progress) and the
        # periodic-checkpoint cadence would fire immediately on
        # re-placement (executed_time - ckpt_executed still >= interval)
        st.lost_work_s += max(0.0, s.executed_time - s.ckpt_executed)
        s.attained_service = s.ckpt_service
        s.executed_time = s.ckpt_executed
        s.gpus = frozenset()
        st.holders.discard(s.job_id)
        s.packed_with = None
        s.migration_debt = 0.0
        if preempt:
            s.preemptions += 1
            st.preemptions += 1
            self._metrics.counter("faults.preemptions").inc()
        s.retries += 1
        st.retries_total += 1
        self._metrics.counter("faults.retries").inc()
        self._metrics.gauge("faults.lost_iters").set(st.lost_iters)
        self._metrics.gauge("faults.lost_work_s").set(st.lost_work_s)
        # drop the job from the relabelling's view of the previous round so
        # its eventual re-placement is a RESUME (checkpoint load), not a
        # migration of live state that no longer exists
        st.prev_gpus.pop(s.job_id, None)
        if st.prev_plan is not None:
            st.prev_plan.remove_job(s.job_id)
        if s.retries > cfg.max_retries:
            s.failed = True
            s.finish_time = st.now
            st.live.pop(s.job_id, None)
            st.failed_jobs.append(s.job_id)
            self._metrics.counter("faults.failed_jobs").inc()
        else:
            s.eligible_time = st.now + cfg.backoff_base_s * (
                cfg.backoff_factor ** (s.retries - 1)
            )

    # ------------------------------------------------------------------ #
    def _typed_profile(self, gpus) -> ThroughputProfile:
        """Ground-truth profile for a job on ``gpus`` (physical GPU ids).

        Homogeneous clusters (``node_gpu_types`` unset) always return
        ``true_profile`` itself.  On heterogeneous clusters the job runs
        at the profile of the SLOWEST GPU type it touches (synchronous
        training is bound by its slowest worker)."""
        if self.cluster.node_gpu_types is None or not gpus:
            return self.true_profile
        types = {
            self.cluster.gpu_type_of(self.cluster.node_of(g)) for g in gpus
        }
        slowest = min(types, key=lambda t: (GPU_TYPES[t].speed, t))
        return self.true_profile.for_gpu_type(slowest)

    def _ckpt_interval_s(
        self, s: JobState, health: Optional[ClusterHealth], now: float
    ) -> float:
        """Per-job periodic-checkpoint cadence for this round.

        Fixed ``checkpoint_interval_s`` unless ``adaptive_checkpoint`` is
        on AND the outage process has been observed; then Young's interval
        ``sqrt(2 * delta * MTBF_job)`` with ``delta`` = half the job's
        migration overhead (the checkpoint write is the save half of the
        save+load+warmup cost, Fig. 3) and the job's effective MTBF the
        pooled per-node estimate divided by the nodes it spans (a gang
        dies when ANY of its nodes does).  Clamped to
        ``[round_duration_s, checkpoint_interval_s]``.
        """
        cfg = self.config
        base = cfg.checkpoint_interval_s
        if not cfg.adaptive_checkpoint or health is None:
            return base
        mtbf = health.empirical_mtbf_s(now)
        if mtbf is None:
            return base
        nodes_spanned = len({self.cluster.node_of(g) for g in s.gpus}) or 1
        delta = 0.5 * migration_overhead_s(s.spec.model)
        young = (2.0 * delta * mtbf / nodes_spanned) ** 0.5
        return min(base, max(cfg.round_duration_s, young))

    def _advance_round(self, decision: RoundDecision, st: _SimState) -> None:
        # ``swept``: the previous round's GPU holders, which the release
        # loop visits in place of every job of the trace
        with tracer_of(self.obs).span("advance_round", swept=len(st.holders)):
            self._advance_round_impl(decision, st)

    def _advance_round_impl(self, decision: RoundDecision, st: _SimState) -> None:
        cfg = self.config
        states, now, prev_gpus, health = st.states, st.now, st.prev_gpus, st.health
        plan_map = decision.plan.job_gpu_map()
        packed_partner: Dict[int, int] = {}
        for pending_id, placed_id in decision.packing.matches.items():
            packed_partner[pending_id] = placed_id
            packed_partner[placed_id] = pending_id
        degraded = health.degraded

        for jid, gpus in plan_map.items():
            s = states[jid]
            if s.finished:
                continue
            # strategy chosen by the packing matcher applies WHILE PACKED;
            # an unpacked job reverts to its best isolated strategy (dp)
            s.strategy = decision.packing.strategies.get(jid, "dp")
            # migration / startup debt: a job entering the plan from the
            # outside pays the cold-start fraction on its FIRST placement
            # ever (warmup + initial load) and the resume fraction when it
            # returns from preemption (checkpoint load + warmup); a job
            # changing GPUs within the plan pays the full migration debt.
            if cfg.migration_penalty:
                prev = prev_gpus.get(jid)
                if prev is None:
                    cold_start = s.executed_time == 0.0
                    frac = (
                        cfg.startup_fraction
                        if cold_start or cfg.resume_fraction is None
                        else cfg.resume_fraction
                    )
                    s.migration_debt += frac * migration_overhead_s(s.spec.model)
                elif prev != gpus:
                    s.migrations += 1
                    s.migration_debt += migration_overhead_s(s.spec.model)
                    # a voluntary migration checkpoints before moving —
                    # only crashes lose work
                    s.ckpt_iters = s.iters_done
                    s.ckpt_executed = s.executed_time
                    s.ckpt_service = s.attained_service
                    # drain telemetry: did this move leave a degraded node
                    # for strictly faster ones?
                    prev_speed = min(
                        health.speed_factor[self.cluster.node_of(g)] for g in prev
                    )
                    new_speed = min(
                        health.speed_factor[self.cluster.node_of(g)] for g in gpus
                    )
                    if prev_speed < 1.0 and new_speed > prev_speed:
                        st.drain_migrations += 1
            s.gpus = gpus

            # heterogeneous clusters: the job's TRUE rate (and packing
            # interference, incl. HBM feasibility) is profiled on the GPU
            # type it actually landed on — the slowest participating node
            # bounds a synchronous job.  Homogeneous clusters return
            # ``true_profile`` itself (the bit-identical seed path).
            prof = self._typed_profile(gpus)
            partner = packed_partner.get(jid)
            factor = 1.0
            if partner is not None and partner in plan_map:
                me, other = s.spec.model, states[partner].spec.model
                na, nb = prof.normalized_packed(
                    me, other, strat_a=s.strategy, strat_b=states[partner].strategy
                )
                factor = na if na > 0 else 1.0
            rate = prof.isolated(s.spec.model, s.num_gpus, s.strategy) * factor
            if degraded:
                # truth-side straggler model: a synchronous job runs at the
                # slowest touched node's speed; the scheduler's beliefs
                # (and hence the plan) are unchanged
                slow = min(
                    health.speed_factor[self.cluster.node_of(g)] for g in gpus
                )
                if slow != 1.0:
                    rate *= slow

            debt = min(s.migration_debt, cfg.round_duration_s)
            s.migration_debt -= debt
            run_time = cfg.round_duration_s - debt
            if s.first_run_time is None:
                s.first_run_time = now + debt
            remaining = s.remaining_iters()
            if rate * run_time >= remaining and rate > 0:
                finish_delay = debt + remaining / rate
                s.iters_done = s.spec.total_iters
                s.finish_time = now + finish_delay
                s.executed_time += remaining / rate
                s.attained_service += s.num_gpus * (remaining / rate)
                st.live.pop(jid, None)
            else:
                s.iters_done += rate * run_time
                s.executed_time += run_time
                s.attained_service += s.num_gpus * run_time
                # periodic checkpoint (inert bookkeeping until a crash
                # reads it): cadence measured in executed time
                if (
                    s.executed_time - s.ckpt_executed
                    >= self._ckpt_interval_s(s, health, now)
                ):
                    s.ckpt_iters = s.iters_done
                    s.ckpt_executed = s.executed_time
                    s.ckpt_service = s.attained_service

        # jobs not in the plan keep waiting (attain no service); a job the
        # scheduler just released drained gracefully, i.e. it checkpointed.
        # Only the previous round's GPU holders have GPUs to release.
        for jid in st.holders:
            if jid not in plan_map:
                s = states[jid]
                s.ckpt_iters = s.iters_done
                s.ckpt_executed = s.executed_time
                s.ckpt_service = s.attained_service
                s.gpus = frozenset()
        st.holders = {jid for jid in plan_map if not states[jid].finished}

    # ------------------------------------------------------------------ #
    # Crash snapshot / resume
    # ------------------------------------------------------------------ #
    def save_state(self, path: str) -> None:
        """Serialise the paused round state (see ``run(stop_after_rounds)``)
        plus the scheduler's :class:`MatchContext` warm state into one
        versioned ``.npz``.  A simulator constructed with the same
        (cluster, trace, scheduler config, failures) that calls
        :meth:`load_state` then :meth:`run` finishes bit-identical to the
        uninterrupted run.  Policy-internal state (Gavel's LP) is not
        captured."""
        st = self._state
        if st is None:
            raise RuntimeError(
                "no paused run to snapshot — call run(stop_after_rounds=k) first"
            )
        jobs_meta: Dict[str, Dict] = {}
        for jid, s in st.states.items():
            d = {f: getattr(s, f) for f in _JOB_STATE_FIELDS}
            d["gpus"] = sorted(int(g) for g in s.gpus)
            jobs_meta[str(jid)] = d
        meta = {
            "version": SIM_STATE_VERSION,
            "now": st.now,
            "rounds": st.rounds,
            "total_migrations": st.total_migrations,
            "lp_refresh_s": st.lp_refresh_s,
            "event_idx": st.event_idx,
            "events_applied": st.events_applied,
            "preemptions": st.preemptions,
            "retries_total": st.retries_total,
            "lost_iters": st.lost_iters,
            "lost_work_s": st.lost_work_s,
            "drain_migrations": st.drain_migrations,
            "health_outages": st.health.outages,
            "failed_jobs": st.failed_jobs,
            "degrade_rounds": st.degrade_rounds,
            "overhead": st.overhead,
            "match_rounds": st.match_rounds,
            "contention_num": {str(k): v for k, v in st.contention_num.items()},
            "contention_den": {str(k): v for k, v in st.contention_den.items()},
            "prev_gpus": {
                str(j): sorted(int(g) for g in gs)
                for j, gs in st.prev_gpus.items()
            },
            "jobs": jobs_meta,
            "has_prev_plan": st.prev_plan is not None,
            "prewarm_wall": st.prewarm_wall,
            "prewarm_overlap": st.prewarm_overlap,
        }
        ctx_meta, ctx_arrays = self.scheduler.match_context.state_payload()
        meta["ctx"] = ctx_meta
        arrays = {f"ctx.{k}": v for k, v in ctx_arrays.items()}
        arrays["health_up"] = st.health.up
        arrays["health_speed"] = st.health.speed_factor
        if st.prev_plan is not None:
            arrays["prev_plan"] = st.prev_plan.slots
        arrays["meta_json"] = np.array(json.dumps(meta))
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    def load_state(self, path: str) -> None:
        """Restore a :meth:`save_state` snapshot into this simulator (and
        its scheduler's :class:`MatchContext`); the next :meth:`run` call
        continues from the saved round."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta_json"][()]))
            if meta.get("version") != SIM_STATE_VERSION:
                raise ValueError(
                    f"{path}: simulator state version {meta.get('version')!r} "
                    f"!= {SIM_STATE_VERSION!r}"
                )
            states: Dict[int, JobState] = {
                s.job_id: JobState(spec=s) for s in self.trace
            }
            for jid_s, d in meta["jobs"].items():
                s = states[int(jid_s)]
                for f in _JOB_STATE_FIELDS:
                    setattr(s, f, d[f])
                s.gpus = frozenset(int(g) for g in d["gpus"])
            health = ClusterHealth(self.cluster.num_nodes)
            health.up = np.asarray(z["health_up"], bool).copy()
            health.speed_factor = np.asarray(z["health_speed"], np.float64).copy()
            health.outages = int(meta["health_outages"])
            prev_plan = None
            if meta["has_prev_plan"]:
                prev_plan = PlacementPlan(
                    self.cluster, np.asarray(z["prev_plan"], np.int64).copy()
                )
            self._state = _SimState(
                states=states,
                num_gpus_of={s.job_id: s.num_gpus for s in self.trace},
                health=health,
                now=float(meta["now"]),
                rounds=int(meta["rounds"]),
                prev_plan=prev_plan,
                prev_gpus={
                    int(j): frozenset(int(g) for g in gs)
                    for j, gs in meta["prev_gpus"].items()
                },
                total_migrations=int(meta["total_migrations"]),
                match_rounds=list(meta["match_rounds"]),
                overhead=dict(meta["overhead"]),
                lp_refresh_s=float(meta["lp_refresh_s"]),
                contention_num={
                    int(k): v for k, v in meta["contention_num"].items()
                },
                contention_den={
                    int(k): v for k, v in meta["contention_den"].items()
                },
                degrade_rounds=list(meta["degrade_rounds"]),
                event_idx=int(meta["event_idx"]),
                events_applied=int(meta["events_applied"]),
                preemptions=int(meta["preemptions"]),
                retries_total=int(meta["retries_total"]),
                lost_iters=float(meta["lost_iters"]),
                lost_work_s=float(meta["lost_work_s"]),
                drain_migrations=int(meta["drain_migrations"]),
                failed_jobs=[int(j) for j in meta["failed_jobs"]],
                prewarm_wall=float(meta["prewarm_wall"]),
                prewarm_overlap=float(meta["prewarm_overlap"]),
            )
            # the live index is derived, not saved: admit every job that
            # has arrived by ``now`` and is unfinished, then find the holders
            self._scan_active(self._state)
            self._state.holders = {
                jid for jid, s in self._state.live.items() if s.gpus
            }
            self.scheduler.match_context = MatchContext.from_payload(
                meta["ctx"],
                lambda name: z[f"ctx.{name}"],
                device=self.scheduler.match_context.device,
            )
            # the fused planner's device cache is NOT serialised: a cold
            # cache only costs one all-dirty fused round, never changes the
            # plan (the fused program is exact within its budget)
            if self.scheduler._fused_planner is not None:
                self.scheduler._fused_planner.invalidate()
            # fresh registry, reseeded from the snapshot's deterministic
            # telemetry so the resumed run's counters finish equal to an
            # uninterrupted run's (timing histograms excepted — wall time
            # was never part of bit-identity).  Re-attach obs to the
            # restored MatchContext (from_payload builds a bare one).
            self._metrics = (
                self.obs.metrics if self.obs is not None else MetricsRegistry()
            )
            self._metrics.reset()
            self._reseed_metrics(self._state)
            if self.obs is not None and hasattr(
                self.scheduler, "set_observability"
            ):
                self.scheduler.set_observability(self.obs)
