"""Shared helpers for the paper-figure benchmarks (the port's copy of the
JAX repo's ``benchmarks/common.py``; every scheduler takes a ``device``)."""

from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.policies import (
    FailureAwarePolicy,
    GavelPolicy,
    ThemisFtfPolicy,
    TiresiasPolicy,
)
from repro_torch.core.profiler import ThroughputProfile
from repro_torch.core.scheduler import TesseraeScheduler, tiresias_single_packed_ok
from repro_torch.core.simulator import SimConfig, Simulator


def timed(fn: Callable, *args, repeats: int = 3, **kwargs):
    """(result, best_seconds)."""
    best = float("inf")
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        best = min(best, time.perf_counter() - t0)
    return out, best


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


# --------------------------------------------------------------------------- #
# Scheduler configurations used across the end-to-end figures
# --------------------------------------------------------------------------- #
def build_scheduler(
    name: str, cluster: ClusterSpec, profile: ThroughputProfile, device=None
) -> TesseraeScheduler:
    """The named scheduler configurations of §6.1, on ``device`` (the card
    unless the caller asks for the CPU)."""
    kw = dict(device=device)
    if name == "tiresias":
        # plain Tiresias: no packing, no migration remapping
        return TesseraeScheduler(
            cluster,
            TiresiasPolicy(profile),
            profile,
            enable_packing=False,
            migration_algorithm="none",
            **kw,
        )
    if name == "tiresias-single":
        # Tiresias scheduling + Tesserae packing restricted to 1-GPU jobs
        return TesseraeScheduler(
            cluster,
            TiresiasPolicy(profile),
            profile,
            enable_packing=True,
            migration_algorithm="none",
            packed_ok=tiresias_single_packed_ok,
            **kw,
        )
    if name == "tesserae-t":
        return TesseraeScheduler(
            cluster, TiresiasPolicy(profile), profile,
            enable_packing=True, migration_algorithm="node", **kw,
        )
    if name == "tesserae-t-fa":
        # failure-aware Tesserae-T: straggler-drain relabel penalties,
        # MTBF-hot domain spread for large gangs, and (in the evaluation
        # harness) the adaptive checkpoint cadence.  On clean traces the
        # health terms never activate and the arm is identical to
        # tesserae-t.
        return TesseraeScheduler(
            cluster,
            FailureAwarePolicy(TiresiasPolicy(profile)),
            profile,
            enable_packing=True,
            migration_algorithm="node",
            health_aware=True,
            **kw,
        )
    if name == "tesserae-t-nomig":
        # ablation: Tesserae packing with Gavel's basic migration policy
        return TesseraeScheduler(
            cluster, TiresiasPolicy(profile), profile,
            enable_packing=True, migration_algorithm="none", **kw,
        )
    if name == "gavel":
        # Gavel: LP-based priorities + packing, basic migration
        return TesseraeScheduler(
            cluster, GavelPolicy(profile), profile,
            enable_packing=True, migration_algorithm="none", **kw,
        )
    if name == "gavel-ftf":
        pol = GavelPolicy(profile)
        pol.name = "gavel-ftf"
        return TesseraeScheduler(
            cluster, pol, profile, enable_packing=True, migration_algorithm="none", **kw
        )
    if name == "tesserae-ftf":
        return TesseraeScheduler(
            cluster, ThemisFtfPolicy(profile), profile,
            enable_packing=True, migration_algorithm="node", **kw,
        )
    if name == "ftf":
        return TesseraeScheduler(
            cluster, ThemisFtfPolicy(profile), profile,
            enable_packing=False, migration_algorithm="none", **kw,
        )
    raise ValueError(name)


def simulate(
    name: str,
    cluster: ClusterSpec,
    trace,
    profile: ThroughputProfile,
    sched_profile: Optional[ThroughputProfile] = None,
    device=None,
    **sim_kwargs,
):
    sched = build_scheduler(name, cluster, sched_profile or profile, device)
    return Simulator(cluster, trace, sched, profile, SimConfig(**sim_kwargs)).run()
