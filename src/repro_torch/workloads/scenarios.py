"""Named workload scenarios: ``workloads.scenario("philly-like-burst")``.

A :class:`Scenario` bundles everything one evaluation arm needs — a trace
source (synthetic recipe, CSV loader or fixture generator) plus a cluster
shape (optionally heterogeneous / racked) — behind a name, so the
evaluation harness, tests and CI all sweep the same registry instead of
re-hand-rolling workloads.  Every scenario is **seeded-deterministic**:
``make_trace(seed)`` is a pure function of its arguments.

Registry (see README for the full table):

====================  =======================================================
``poisson-steady``    stationary Poisson arrivals, Shockwave-class durations
``diurnal-lognorm``   diurnal arrivals (4x peak/trough), lognormal durations
``philly-like-burst`` bursty arrivals, Pareto heavy-tail durations, gang
                      skew, 10% production (non-packable) jobs
``tiresias-churn``    oversubscribed arrivals + bimodal durations — drives
                      Tiresias demotion/resume churn, the warm-start
                      stress regime
``philly-sample``     loader-backed: the committed Philly-style CSV
``shockwave-fixture`` the paper's Shockwave-like fixture generator
``gavel-fixture``     the paper's Gavel-like fixture generator
``hetero-mixed``      philly-like workload on a half-A100 / half-V100
                      two-rack cluster (type- and topology-aware paths on)
``node-flaky``        poisson-steady workload + aggressive node
                      crash/recover churn (1h MTBF) — fault-tolerance
                      stress regime
``philly-failures``   philly-like burst under the full Helios-shaped
                      failure mix (outages + degradations + job failures)
====================  =======================================================

Custom scenarios register with :func:`register_scenario`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import FailureEvent
from repro_torch.core.profiler import ThroughputProfile
from repro_torch.workloads import loaders
from repro_torch.workloads.failures import (
    FailureRecipe,
    GpuDegradations,
    JobFailures,
    NodeOutages,
    generate_failures,
)
from repro_torch.workloads.generators import (
    Arrivals,
    Durations,
    GangSizes,
    TraceRecipe,
    generate_trace,
)
from repro_torch.workloads.schema import JobTrace


def homogeneous_cluster(num_gpus: int, gpus_per_node: int = 4) -> ClusterSpec:
    if num_gpus % gpus_per_node:
        raise ValueError(f"{num_gpus} GPUs not a multiple of node size {gpus_per_node}")
    return ClusterSpec(num_gpus // gpus_per_node, gpus_per_node)


def racked_cluster(
    num_gpus: int, gpus_per_node: int = 4, nodes_per_rack: int = 2
) -> ClusterSpec:
    """Homogeneous cluster with a rack topology (rack = failure domain):
    the shape the failure scenarios run on, so domain-spread placement
    and rack-aware relabelling have real domains to work with."""
    base = homogeneous_cluster(num_gpus, gpus_per_node)
    return dataclasses.replace(base, nodes_per_rack=nodes_per_rack)


def mixed_a100_v100_cluster(num_gpus: int, gpus_per_node: int = 4) -> ClusterSpec:
    """Half A100 / half V100 nodes, one rack per type — the Gavel-style
    heterogeneity regime where packing feasibility (16 vs 40 GB HBM) and
    per-type speed flip policy rankings."""
    base = homogeneous_cluster(num_gpus, gpus_per_node)
    kc = base.num_nodes
    half = max(1, kc // 2)
    types = ("a100",) * half + ("v100",) * (kc - half)
    return ClusterSpec(
        kc,
        gpus_per_node,
        node_gpu_types=types,
        nodes_per_rack=half,
    )


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    kind: str  # "synthetic" | "loader" | "fixture"
    #: trace factory: (seed, num_jobs, profile) -> List[JobTrace]
    trace_fn: Callable[[int, int, Optional[ThroughputProfile]], List[JobTrace]]
    #: cluster factory: (num_gpus) -> ClusterSpec
    cluster_fn: Callable[[int], ClusterSpec] = homogeneous_cluster
    default_num_jobs: int = 120
    heterogeneous: bool = False
    #: optional failure model: the :class:`repro_torch.workloads.failures.FailureRecipe`
    #: this scenario injects (None = fault-free — the seed behaviour).
    failure_recipe: Optional[FailureRecipe] = None

    def make_trace(
        self,
        seed: int,
        num_jobs: Optional[int] = None,
        profile: Optional[ThroughputProfile] = None,
    ) -> List[JobTrace]:
        return self.trace_fn(seed, num_jobs or self.default_num_jobs, profile)

    def make_cluster(self, num_gpus: int) -> ClusterSpec:
        return self.cluster_fn(num_gpus)

    def make_failures(
        self,
        seed: int,
        cluster: ClusterSpec,
        horizon_s: float,
        trace: Optional[List[JobTrace]] = None,
    ) -> List[FailureEvent]:
        """Seeded failure-event stream for one arm (empty for fault-free
        scenarios).  Deterministic in ``(scenario, seed, cluster shape)``
        — the same contract as :meth:`make_trace`."""
        if self.failure_recipe is None:
            return []
        return generate_failures(
            self.failure_recipe, cluster, horizon_s, seed, trace=trace
        )


_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(s: Scenario) -> Scenario:
    if s.name in _REGISTRY:
        raise ValueError(f"scenario {s.name!r} already registered")
    _REGISTRY[s.name] = s
    return s


def scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {list_scenarios()}"
        ) from None


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


def _synthetic(recipe: TraceRecipe):
    def fn(seed: int, num_jobs: int, profile=None) -> List[JobTrace]:
        return generate_trace(recipe, num_jobs, seed, profile)

    return fn


# --------------------------------------------------------------------------- #
# Built-in registry
# --------------------------------------------------------------------------- #
register_scenario(
    Scenario(
        name="poisson-steady",
        description="stationary Poisson arrivals, Shockwave-class durations",
        kind="synthetic",
        trace_fn=_synthetic(
            TraceRecipe(
                arrivals=Arrivals(kind="poisson", rate_per_hour=60.0),
                durations=Durations(kind="lognormal", median_s=2400.0, sigma=1.1),
                gangs=GangSizes(probs=(0.60, 0.30, 0.09, 0.01)),
            )
        ),
    )
)

register_scenario(
    Scenario(
        name="diurnal-lognorm",
        description="diurnal arrivals (4x peak/trough), lognormal durations",
        kind="synthetic",
        trace_fn=_synthetic(
            TraceRecipe(
                arrivals=Arrivals(kind="diurnal", rate_per_hour=60.0, peak_ratio=4.0),
                durations=Durations(kind="lognormal", median_s=1800.0, sigma=1.6),
            )
        ),
    )
)

register_scenario(
    Scenario(
        name="philly-like-burst",
        description=(
            "bursty arrivals, Pareto heavy-tail durations, gang skew, "
            "10% production jobs"
        ),
        kind="synthetic",
        trace_fn=_synthetic(
            TraceRecipe(
                arrivals=Arrivals(kind="bursty", rate_per_hour=70.0),
                durations=Durations(kind="pareto", median_s=900.0, alpha=1.1),
                gangs=GangSizes(probs=(0.55, 0.25, 0.12, 0.08)),
                production_fraction=0.10,
            )
        ),
    )
)

register_scenario(
    Scenario(
        name="tiresias-churn",
        description=(
            "oversubscribed arrivals + bimodal durations: sustained "
            "Tiresias demotion/resume churn (warm-start stress regime)"
        ),
        kind="synthetic",
        trace_fn=_synthetic(
            TraceRecipe(
                arrivals=Arrivals(kind="poisson", rate_per_hour=200.0),
                durations=Durations(kind="lognormal", median_s=3600.0, sigma=0.9),
                gangs=GangSizes(probs=(0.70, 0.20, 0.08, 0.02)),
            )
        ),
    )
)

register_scenario(
    Scenario(
        name="philly-sample",
        description="loader-backed: committed Philly-style CSV sample",
        kind="loader",
        # the file IS the workload: seed and num_jobs only subsample
        trace_fn=lambda seed, num_jobs, profile=None: loaders.philly_sample()[
            :num_jobs
        ],
        default_num_jobs=10**9,  # whole file
    )
)

register_scenario(
    Scenario(
        name="shockwave-fixture",
        description="the paper's Shockwave-like fixture generator (§6.1)",
        kind="fixture",
        trace_fn=lambda seed, num_jobs, profile=None: loaders.shockwave_fixture(
            num_jobs, seed, profile
        ),
    )
)

register_scenario(
    Scenario(
        name="gavel-fixture",
        description="the paper's Gavel-like fixture generator (Fig. 17)",
        kind="fixture",
        trace_fn=lambda seed, num_jobs, profile=None: loaders.gavel_fixture(
            num_jobs, seed, profile
        ),
    )
)

register_scenario(
    Scenario(
        name="node-flaky",
        description=(
            "steady Poisson workload on a cluster with aggressively flaky "
            "nodes (1h MTBF, ~15 min repairs) — the node-crash/recover "
            "stress regime for eviction, retry/backoff and targeted "
            "cache-invalidation paths"
        ),
        kind="synthetic",
        cluster_fn=racked_cluster,
        failure_recipe=FailureRecipe(
            nodes=NodeOutages(
                mtbf_h=1.0, repair_median_s=900.0, repair_sigma=0.6
            )
        ),
        trace_fn=_synthetic(
            TraceRecipe(
                arrivals=Arrivals(kind="poisson", rate_per_hour=60.0),
                durations=Durations(kind="lognormal", median_s=2400.0, sigma=1.1),
                gangs=GangSizes(probs=(0.60, 0.30, 0.09, 0.01)),
            )
        ),
    )
)

register_scenario(
    Scenario(
        name="philly-failures",
        description=(
            "philly-like bursty workload under the Helios-shaped failure "
            "mix (node outages + GPU degradations + per-job software "
            "failures) — the end-to-end graceful-degradation regime"
        ),
        kind="synthetic",
        cluster_fn=racked_cluster,
        failure_recipe=FailureRecipe.helios_like(),
        trace_fn=_synthetic(
            TraceRecipe(
                arrivals=Arrivals(kind="bursty", rate_per_hour=70.0),
                durations=Durations(kind="pareto", median_s=900.0, alpha=1.1),
                gangs=GangSizes(probs=(0.55, 0.25, 0.12, 0.08)),
                production_fraction=0.10,
            )
        ),
    )
)

register_scenario(
    Scenario(
        name="hetero-mixed",
        description=(
            "philly-like workload on a half-A100/half-V100 two-rack "
            "cluster (type- & topology-aware migration and packing)"
        ),
        kind="synthetic",
        heterogeneous=True,
        cluster_fn=mixed_a100_v100_cluster,
        trace_fn=_synthetic(
            TraceRecipe(
                arrivals=Arrivals(kind="poisson", rate_per_hour=60.0),
                durations=Durations(kind="lognormal", median_s=2400.0, sigma=1.2),
                gangs=GangSizes(probs=(0.55, 0.30, 0.10, 0.05)),
            )
        ),
    )
)
