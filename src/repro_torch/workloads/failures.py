"""Seeded, composable failure-event generators (the fault model).

Mirrors the structure of :mod:`repro_torch.workloads.generators`: each failure
axis is a small frozen spec with a ``sample`` method, a
:class:`FailureRecipe` composes one of each, and
:func:`generate_failures` materialises a deterministic, time-sorted
:class:`~repro_torch.core.faults.FailureEvent` stream for a given cluster and
horizon.  The same ``(recipe, cluster, horizon, seed)`` always yields the
identical stream — the chaos differential suite and the CI chaos-smoke
lane gate on that determinism.

Default shapes follow the Helios characterisation (PAPERS.md,
arxiv 2109.01313): node outages are a per-node Poisson process with
lognormal repair times (most repairs are a reboot, a heavy tail is a
hardware swap); a minority of jobs fail at least once and failed jobs
retry a small number of times; slowdowns (thermal / ECC pressure) are
rarer than crashes but last longer.  The absolute rates default far above
production (hours, not weeks, between faults) so short simulations
actually exercise the machinery; scenarios scale them as needed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import (
    GPU_DEGRADE,
    JOB_FAIL,
    NODE_DOWN,
    NODE_UP,
    FailureEvent,
)
from repro_torch.workloads.schema import JobTrace

_H = 3600.0


@dataclasses.dataclass(frozen=True)
class NodeOutages:
    """Per-node crash/recover process: exponential time-between-crashes
    (``mtbf_h`` hours), lognormal repair durations (median
    ``repair_median_s``, shape ``repair_sigma``), at most
    ``max_per_node`` outages per node per trace."""

    mtbf_h: float = 6.0
    repair_median_s: float = 1800.0
    repair_sigma: float = 0.8
    min_repair_s: float = 120.0
    max_per_node: int = 8

    def sample(
        self, rng: np.random.Generator, num_nodes: int, horizon_s: float
    ) -> List[FailureEvent]:
        out: List[FailureEvent] = []
        for node in range(num_nodes):
            t = 0.0
            for _ in range(self.max_per_node):
                t += float(rng.exponential(self.mtbf_h * _H))
                if t >= horizon_s:
                    break
                repair = self.repair_median_s * float(
                    np.exp(self.repair_sigma * rng.standard_normal())
                )
                repair = max(repair, self.min_repair_s)
                out.append(FailureEvent(t, NODE_DOWN, node=node))
                t += repair
                if t < horizon_s:
                    out.append(FailureEvent(t, NODE_UP, node=node))
        return out


@dataclasses.dataclass(frozen=True)
class GpuDegradations:
    """Per-node slowdown process (stragglers): Poisson onsets at
    ``rate_per_node_per_day``, uniform severity in ``factor_range``
    (fraction of nominal speed), lognormal episode length; every episode
    is closed with a ``factor=1.0`` restore event."""

    rate_per_node_per_day: float = 1.0
    factor_range: tuple = (0.3, 0.9)
    duration_median_s: float = 3600.0
    duration_sigma: float = 0.6
    max_per_node: int = 8

    def sample(
        self, rng: np.random.Generator, num_nodes: int, horizon_s: float
    ) -> List[FailureEvent]:
        out: List[FailureEvent] = []
        lo, hi = self.factor_range
        for node in range(num_nodes):
            t = 0.0
            for _ in range(self.max_per_node):
                t += float(rng.exponential(24.0 * _H / self.rate_per_node_per_day))
                if t >= horizon_s:
                    break
                factor = float(rng.uniform(lo, hi))
                dur = self.duration_median_s * float(
                    np.exp(self.duration_sigma * rng.standard_normal())
                )
                out.append(FailureEvent(t, GPU_DEGRADE, node=node, factor=factor))
                t += max(dur, 60.0)
                if t < horizon_s:
                    out.append(FailureEvent(t, GPU_DEGRADE, node=node, factor=1.0))
        return out


@dataclasses.dataclass(frozen=True)
class JobFailures:
    """Per-job software-failure hazard: each job independently fails with
    probability ``fail_prob``; a failing job draws 1..``max_failures``
    failure instants spread over a window proportional to its (estimated)
    runtime.  Events that fire while the job is queued or already done are
    dropped by the simulator — the hazard missed — so the realised failure
    rate is a lower bound on ``fail_prob`` under contention."""

    fail_prob: float = 0.15
    max_failures: int = 2
    #: runtime estimate for iteration-profiled rows (no ``duration_s``).
    default_runtime_s: float = 3600.0
    #: failures land in ``[0, window_stretch * runtime]`` after arrival —
    #: stretched past 1.0 because queueing delays execution.
    window_stretch: float = 2.0

    def sample(
        self, rng: np.random.Generator, trace: Sequence[JobTrace]
    ) -> List[FailureEvent]:
        out: List[FailureEvent] = []
        for t in trace:
            if float(rng.random()) >= self.fail_prob:
                continue
            k = 1 + int(rng.integers(0, self.max_failures))
            runtime = (
                t.duration_s if t.duration_s is not None else self.default_runtime_s
            )
            window = max(self.window_stretch * runtime, 600.0)
            times = np.sort(rng.uniform(0.0, window, size=k))
            for dt in times:
                out.append(
                    FailureEvent(t.arrival_s + float(dt), JOB_FAIL, job_id=t.job_id)
                )
        return out


@dataclasses.dataclass(frozen=True)
class FailureRecipe:
    """One fault model = node outages x GPU degradations x job failures.
    Any axis may be ``None`` (disabled); the all-``None`` recipe generates
    the empty stream — bit-identical to the failure-free seed path."""

    nodes: Optional[NodeOutages] = None
    gpus: Optional[GpuDegradations] = None
    jobs: Optional[JobFailures] = None

    @classmethod
    def helios_like(cls) -> "FailureRecipe":
        """All three axes at the Helios-shaped defaults."""
        return cls(nodes=NodeOutages(), gpus=GpuDegradations(), jobs=JobFailures())


def generate_failures(
    recipe: FailureRecipe,
    cluster: ClusterSpec,
    horizon_s: float,
    seed: int,
    trace: Optional[Sequence[JobTrace]] = None,
) -> List[FailureEvent]:
    """Materialise the recipe's event stream, deterministically in ``seed``.

    Each axis draws from its own child RNG stream (``spawn_key``-style
    offsets of the seed), so enabling one axis never perturbs another's
    draws — recipes compose without cross-talk.  The merged stream is
    sorted by :meth:`FailureEvent.sort_key` (time, then kind, then
    target), a total order, so the output is unique regardless of
    generation order.
    """
    events: List[FailureEvent] = []
    if recipe.nodes is not None:
        rng = np.random.default_rng([seed, 0xFA01])
        events.extend(recipe.nodes.sample(rng, cluster.num_nodes, horizon_s))
    if recipe.gpus is not None:
        rng = np.random.default_rng([seed, 0xFA02])
        events.extend(recipe.gpus.sample(rng, cluster.num_nodes, horizon_s))
    if recipe.jobs is not None and trace:
        rng = np.random.default_rng([seed, 0xFA03])
        events.extend(recipe.jobs.sample(rng, trace))
        events = [e for e in events if e.time_s < horizon_s]
    return sorted(events, key=FailureEvent.sort_key)
