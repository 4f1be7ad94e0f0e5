"""Scheduling (priority-ordering) policies Tesserae composes with.

Tesserae deliberately does NOT invent a scheduling policy: it consumes the
priority order produced by an existing one (§3.1).  We implement the ones
the paper evaluates with — FIFO, SRTF, Tiresias 2D-LAS, Themis FTF — plus
the optimisation-based baselines Gavel (LP) and POP (partitioned LP), which
are *whole schedulers* used for the scalability and JCT comparisons.
"""

from repro_torch.core.policies.base import SchedulingPolicy
from repro_torch.core.policies.simple import FifoPolicy, SrtfPolicy
from repro_torch.core.policies.tiresias import TiresiasPolicy
from repro_torch.core.policies.themis import ThemisFtfPolicy
from repro_torch.core.policies.gavel import GavelPolicy, PopPolicy
from repro_torch.core.policies.failure_aware import FailureAwarePolicy

POLICIES = {
    "fifo": FifoPolicy,
    "srtf": SrtfPolicy,
    "tiresias": TiresiasPolicy,
    "ftf": ThemisFtfPolicy,
    "gavel": GavelPolicy,
    "pop": PopPolicy,
}

__all__ = [
    "SchedulingPolicy",
    "FifoPolicy",
    "SrtfPolicy",
    "TiresiasPolicy",
    "ThemisFtfPolicy",
    "GavelPolicy",
    "PopPolicy",
    "FailureAwarePolicy",
    "POLICIES",
]
