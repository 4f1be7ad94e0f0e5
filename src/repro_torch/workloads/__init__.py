"""Workload scenario lab (the evaluation side of the reproduction).

The port's own copy of the JAX package's ``repro.workloads``: numpy only,
the same names, the same seeded call order (so traces, failure streams and
files come out equal), built on ``repro_torch.core``.

Everything the scheduler is *driven with* lives here, behind one schema:

* :mod:`repro_torch.workloads.schema` — the canonical :class:`JobTrace` record
  (arrival, gang size, duration/iteration profile, model tag, priority
  class) with JSON round-tripping and materialisation into simulator
  :class:`~repro_torch.core.jobs.JobSpec` lists;
* :mod:`repro_torch.workloads.generators` — seeded, composable synthetic
  generators (Poisson / diurnal / bursty arrivals, lognormal / Pareto
  heavy-tail durations, gang-size skew, priority mixes);
* :mod:`repro_torch.workloads.failures` — seeded, composable failure-event
  generators (node outages, GPU degradations, per-job software failures)
  behind a :class:`FailureRecipe`, feeding the simulator's
  fault-injection layer;
* :mod:`repro_torch.workloads.loaders` — Philly-style CSV loader (+ committed
  sample) and loaders for the in-repo fixture generators;
* :mod:`repro_torch.workloads.scenarios` — the named-scenario registry:
  ``workloads.scenario("philly-like-burst")`` returns a trace factory and
  a (possibly heterogeneous / racked) cluster factory the evaluation
  harness (:mod:`repro_torch.benchmarks.evaluate`) sweeps.

Determinism contract: every scenario trace is a pure function of
``(scenario, seed, num_jobs)`` — CI gates on it.
"""

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
from repro_torch.workloads.loaders import (
    gavel_fixture,
    load_philly_csv,
    philly_sample,
    save_philly_csv,
    shockwave_fixture,
)
from repro_torch.workloads.scenarios import (
    Scenario,
    homogeneous_cluster,
    list_scenarios,
    mixed_a100_v100_cluster,
    register_scenario,
    scenario,
)
from repro_torch.workloads.schema import (
    PRIORITY_CLASSES,
    SCHEMA_VERSION,
    JobTrace,
    from_jobspecs,
    load_json,
    load_json_with_failures,
    save_json,
    to_jobspecs,
)

__all__ = [
    "Arrivals",
    "Durations",
    "FailureRecipe",
    "GangSizes",
    "GpuDegradations",
    "JobFailures",
    "JobTrace",
    "NodeOutages",
    "PRIORITY_CLASSES",
    "SCHEMA_VERSION",
    "Scenario",
    "TraceRecipe",
    "from_jobspecs",
    "gavel_fixture",
    "generate_failures",
    "generate_trace",
    "homogeneous_cluster",
    "list_scenarios",
    "load_json",
    "load_json_with_failures",
    "load_philly_csv",
    "mixed_a100_v100_cluster",
    "philly_sample",
    "register_scenario",
    "save_json",
    "save_philly_csv",
    "scenario",
    "shockwave_fixture",
    "to_jobspecs",
]
