"""Failure events for the fault-injection layer (Helios/Philly semantics).

Real GPU clusters lose whole nodes (hardware faults, maintenance reboots),
see individual accelerators degrade (thermal throttling, ECC retirement
pressure) and lose jobs outright (OOM, NCCL timeouts, user bugs) — the
Helios/Philly characterisations (PAPERS.md, arxiv 2109.01313) show these
events dominate tail behaviour.  This module defines the EVENT vocabulary
the simulator consumes; the seeded generators that *emit* these events
live in :mod:`repro_torch.workloads.failures` (the workload side of the lab),
keeping the dependency direction workloads -> core.

Semantics (enforced by :class:`~repro_torch.core.simulator.Simulator`):

* ``node-down`` — the node drops to zero capacity; every job with at
  least one GPU on it is preempted WITHOUT a checkpoint save (work since
  the last checkpoint is lost) and requeued through the retry/backoff
  ladder.
* ``node-up`` — the node rejoins at full speed; the scheduler's warm
  matching state for it is invalidated (targeted — healthy nodes keep
  their warm state).
* ``gpu-degrade`` — the node's GPUs run at ``factor`` of nominal speed
  (``factor=1.0`` restores).  Truth-side only: the scheduler's beliefs
  are unchanged, modelling an undetected straggler.
* ``job-fail`` — a software failure of one running job: lost work back to
  the last checkpoint, one retry consumed, exponential backoff before the
  job is eligible again.  A job that is not running when the event fires
  is unaffected (the hazard missed).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

NODE_DOWN = "node-down"
NODE_UP = "node-up"
GPU_DEGRADE = "gpu-degrade"
JOB_FAIL = "job-fail"

EVENT_KINDS = (NODE_DOWN, NODE_UP, GPU_DEGRADE, JOB_FAIL)


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One failure-model event, applied at the first round boundary at or
    after ``time_s`` (round-based semantics, like everything else in the
    simulator)."""

    time_s: float
    kind: str
    #: target node (``node-down`` / ``node-up`` / ``gpu-degrade``).
    node: Optional[int] = None
    #: target job (``job-fail``).
    job_id: Optional[int] = None
    #: speed factor in (0, 1] for ``gpu-degrade``; 1.0 restores nominal.
    factor: Optional[float] = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown failure-event kind {self.kind!r}; "
                f"expected one of {EVENT_KINDS}"
            )
        if self.time_s < 0:
            raise ValueError(f"{self.kind}: negative event time {self.time_s}")
        if self.kind in (NODE_DOWN, NODE_UP, GPU_DEGRADE):
            if self.node is None or self.node < 0:
                raise ValueError(f"{self.kind}: needs a non-negative node")
        if self.kind == JOB_FAIL and self.job_id is None:
            raise ValueError(f"{self.kind}: needs a job_id")
        if self.kind == GPU_DEGRADE:
            if self.factor is None or not (0.0 < self.factor <= 1.0):
                raise ValueError(
                    f"{self.kind}: factor must be in (0, 1], got {self.factor}"
                )

    #: deterministic total order for merged event streams: time first,
    #: then kind (ups before downs at the same instant would resurrect a
    #: node mid-crash, so downs sort first via the EVENT_KINDS index),
    #: then targets.
    def sort_key(self):
        return (
            self.time_s,
            EVENT_KINDS.index(self.kind),
            -1 if self.node is None else self.node,
            -1 if self.job_id is None else self.job_id,
        )

    # -- (de)serialisation (the JobTrace JSON envelope's failure rows) ---- #
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    @classmethod
    def from_dict(cls, d: Dict) -> "FailureEvent":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown FailureEvent fields: {sorted(unknown)}")
        return cls(**d)
