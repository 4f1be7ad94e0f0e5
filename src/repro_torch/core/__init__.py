"""Tesserae core: graph-matching placement policies for DL cluster scheduling.

Public API:

* :class:`repro_torch.core.scheduler.TesseraeScheduler` — the round scheduler
  (Listing 1) composing any :class:`~repro_torch.core.policies.SchedulingPolicy`
  with the graph-based migration (§4.1) and packing (§4.2) policies.
* :class:`repro_torch.core.simulator.Simulator` — round-based cluster simulator.
* :mod:`repro_torch.core.matching` — LAP solvers (numpy Hungarian, scipy, torch
  auction with the ``lap_bid`` CUDA kernel).
"""

from repro_torch.core.cluster import ClusterSpec, PlacementPlan, count_migrations
from repro_torch.core.jobs import JobSpec, JobState
from repro_torch.core.migration import plan_migration, plan_migration_batched_auction
from repro_torch.core.packing import pack_jobs
from repro_torch.core.placement import place_without_packing
from repro_torch.core.profiler import ThroughputProfile, register_model
from repro_torch.core.scheduler import TesseraeScheduler, tiresias_single_packed_ok
from repro_torch.core.simulator import SimConfig, Simulator

__all__ = [
    "ClusterSpec",
    "PlacementPlan",
    "count_migrations",
    "JobSpec",
    "JobState",
    "plan_migration",
    "plan_migration_batched_auction",
    "pack_jobs",
    "place_without_packing",
    "ThroughputProfile",
    "register_model",
    "TesseraeScheduler",
    "tiresias_single_packed_ok",
    "SimConfig",
    "Simulator",
]
