"""Canonical workload-trace schema (the scenario lab's interchange format).

A :class:`JobTrace` is ONE submitted job as a cluster trace records it:
arrival, gang size, a duration/iteration profile, a model tag and a
priority class.  It deliberately carries *either* a wall-clock duration
(what real traces like Philly publish — runtime at the job's own gang
size) *or* an explicit iteration count (what the simulator ultimately
consumes); :meth:`JobTrace.to_jobspec` materialises the former through a
:class:`~repro_torch.core.profiler.ThroughputProfile` using the exact conversion
rule of the fixture generators (:func:`repro_torch.core.traces.iters_for_duration`),
so loader-backed and synthetic scenarios drive the scheduler identically.

Every trace round-trips through JSON (:func:`save_json` / :func:`load_json`)
with a versioned envelope, which is how sweeps archive the exact workload
they measured.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.faults import FailureEvent
from repro_torch.core.jobs import JobSpec
from repro_torch.core.profiler import MODEL_CATALOG, ThroughputProfile
from repro_torch.core.traces import iters_for_duration

#: v2 adds an optional top-level ``failures`` list (fault-model events,
#: :class:`~repro_torch.core.faults.FailureEvent` rows) to the envelope.  The
#: job-row schema is unchanged, so v1 documents load as-is.
SCHEMA_VERSION = "tesserae-trace-v2"
_COMPAT_VERSIONS = ("tesserae-trace-v1", SCHEMA_VERSION)

#: priority classes: "production" jobs carry strict SLOs and bypass packing
#: (§4.3 "Fairness" — no Algorithm-4 edges), "best-effort" jobs pack freely.
PRIORITY_CLASSES = ("best-effort", "production")


@dataclasses.dataclass(frozen=True)
class JobTrace:
    """One trace row.  Exactly one of ``duration_s`` / ``total_iters`` is
    set; ``duration_s`` is the isolated runtime at the job's own gang size."""

    job_id: int
    model: str
    num_gpus: int
    arrival_s: float
    duration_s: Optional[float] = None
    total_iters: Optional[float] = None
    priority: str = "best-effort"
    batch_size: int = 32

    def __post_init__(self):
        if (self.duration_s is None) == (self.total_iters is None):
            raise ValueError(
                f"job {self.job_id}: exactly one of duration_s/total_iters "
                f"must be set (got duration_s={self.duration_s}, "
                f"total_iters={self.total_iters})"
            )
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"job {self.job_id}: unknown priority {self.priority!r}; "
                f"expected one of {PRIORITY_CLASSES}"
            )
        if self.num_gpus <= 0:
            raise ValueError(f"job {self.job_id}: num_gpus must be positive")
        if self.arrival_s < 0:
            raise ValueError(f"job {self.job_id}: negative arrival")

    # -- materialisation -------------------------------------------------- #
    def to_jobspec(self, profile: Optional[ThroughputProfile] = None) -> JobSpec:
        profile = profile or ThroughputProfile()
        iters = (
            self.total_iters
            if self.total_iters is not None
            else iters_for_duration(self.model, self.num_gpus, self.duration_s, profile)
        )
        return JobSpec(
            job_id=self.job_id,
            model=self.model,
            num_gpus=self.num_gpus,
            total_iters=float(iters),
            arrival_time=float(self.arrival_s),
            batch_size=self.batch_size,
            packable=self.priority != "production",
            is_llm=MODEL_CATALOG[self.model].is_llm,
        )

    # -- (de)serialisation ------------------------------------------------ #
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    @classmethod
    def from_dict(cls, d: Dict) -> "JobTrace":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown JobTrace fields: {sorted(unknown)}")
        return cls(**d)


def to_jobspecs(
    trace: Sequence[JobTrace], profile: Optional[ThroughputProfile] = None
) -> List[JobSpec]:
    """Materialise a whole trace, sorted the way the simulator consumes it."""
    profile = profile or ThroughputProfile()
    specs = [t.to_jobspec(profile) for t in trace]
    return sorted(specs, key=lambda s: (s.arrival_time, s.job_id))


def from_jobspecs(specs: Sequence[JobSpec]) -> List[JobTrace]:
    """Loader for the existing fixture generators
    (:func:`repro_torch.core.traces.shockwave_trace` & friends): re-expresses
    their :class:`JobSpec` lists in the canonical schema (iteration-
    profiled, so no profile round-trip error is introduced)."""
    return [
        JobTrace(
            job_id=s.job_id,
            model=s.model,
            num_gpus=s.num_gpus,
            arrival_s=s.arrival_time,
            total_iters=s.total_iters,
            priority="best-effort" if s.packable else "production",
            batch_size=s.batch_size,
        )
        for s in specs
    ]


def save_json(
    path: str,
    trace: Sequence[JobTrace],
    meta: Optional[Dict] = None,
    failures: Optional[Sequence[FailureEvent]] = None,
) -> None:
    doc = {
        "schema": SCHEMA_VERSION,
        "meta": dict(meta or {}),
        "jobs": [t.to_dict() for t in trace],
    }
    if failures is not None:
        # canonical order (FailureEvent.sort_key is a total order), so the
        # archived document is unique regardless of generation order
        doc["failures"] = [
            e.to_dict() for e in sorted(failures, key=FailureEvent.sort_key)
        ]
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)


def load_json(path: str) -> List[JobTrace]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") not in _COMPAT_VERSIONS:
        raise ValueError(
            f"{path}: schema {doc.get('schema')!r} not in {_COMPAT_VERSIONS!r}"
        )
    return [JobTrace.from_dict(d) for d in doc["jobs"]]


def load_json_with_failures(
    path: str,
) -> Tuple[List[JobTrace], List[FailureEvent]]:
    """Like :func:`load_json` but also returns the archived fault-model
    events (empty for v1 documents, which predate the field)."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") not in _COMPAT_VERSIONS:
        raise ValueError(
            f"{path}: schema {doc.get('schema')!r} not in {_COMPAT_VERSIONS!r}"
        )
    jobs = [JobTrace.from_dict(d) for d in doc["jobs"]]
    failures = [FailureEvent.from_dict(d) for d in doc.get("failures", [])]
    return jobs, failures
