"""Trace loaders: Philly-style CSV and the in-repo fixture generators.

**Philly-style CSV** — the column set the Microsoft Philly trace release
(and most cluster dumps derived from it) boils down to:

    job_id,vc,submitted_s,num_gpus,duration_s,model,status

``vc`` is the virtual cluster (production VCs map to the ``production``
priority class — their jobs bypass packing), ``submitted_s`` is seconds
since the trace epoch, ``duration_s`` the observed runtime at the job's
gang size, ``status`` one of Pass/Killed/Failed.  Failed jobs are dropped
(they never represent useful demand); Pass and Killed both count — a
killed job still occupied its gang.  Unknown model tags map
deterministically onto the Table-1 catalog so any Philly-shaped file
loads without a custom catalog (the mapping is a stable hash, not an
RNG).  A small committed sample lives next to this module
(``data/philly_sample.csv``) and backs the ``philly-sample`` scenario.

**Fixture loaders** — :func:`shockwave_fixture` / :func:`gavel_fixture`
wrap the seeded generators of :mod:`repro_torch.core.traces` into the canonical
schema, so the paper's original fixture workloads are first-class
scenarios too.
"""

from __future__ import annotations

import csv
import hashlib
import os
from typing import List, Optional, Sequence

from repro_torch.core.profiler import MODEL_CATALOG, ThroughputProfile
from repro_torch.core.traces import gavel_trace, shockwave_trace
from repro_torch.workloads.schema import JobTrace, from_jobspecs

PHILLY_COLUMNS = (
    "job_id",
    "vc",
    "submitted_s",
    "num_gpus",
    "duration_s",
    "model",
    "status",
)

#: VC names treated as production (strict-priority, non-packable) demand.
PRODUCTION_VCS = frozenset({"prod", "production", "vc-prod"})

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
PHILLY_SAMPLE = os.path.join(DATA_DIR, "philly_sample.csv")


def _canonical_model(tag: str) -> str:
    """Map an arbitrary trace model tag into the profiled catalog.

    Known tags pass through; unknown ones pick a Table-1 model by stable
    hash, so the same file always loads the same workload."""
    if tag in MODEL_CATALOG:
        return tag
    names = sorted(MODEL_CATALOG)
    h = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "little")
    return names[h % len(names)]


def load_philly_csv(path: str) -> List[JobTrace]:
    """Parse a Philly-style CSV into the canonical schema.

    Arrivals are re-based to the earliest surviving submission; rows are
    renumbered in (arrival, file order) so job ids are dense and unique
    regardless of the file's own id column gaps."""
    rows = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        missing = set(PHILLY_COLUMNS) - set(reader.fieldnames or ())
        if missing:
            raise ValueError(f"{path}: missing Philly columns {sorted(missing)}")
        for i, rec in enumerate(reader):
            status = rec["status"].strip().lower()
            if status == "failed":
                continue
            duration = float(rec["duration_s"])
            gpus = int(rec["num_gpus"])
            if duration <= 0 or gpus <= 0:
                continue
            rows.append(
                (
                    float(rec["submitted_s"]),
                    i,
                    _canonical_model(rec["model"].strip()),
                    gpus,
                    duration,
                    rec["vc"].strip().lower(),
                )
            )
    if not rows:
        raise ValueError(f"{path}: no usable rows")
    rows.sort(key=lambda r: (r[0], r[1]))
    t0 = rows[0][0]
    return [
        JobTrace(
            job_id=j,
            model=model,
            num_gpus=gpus,
            arrival_s=submitted - t0,
            duration_s=duration,
            priority="production" if vc in PRODUCTION_VCS else "best-effort",
        )
        for j, (submitted, _, model, gpus, duration, vc) in enumerate(rows)
    ]


def save_philly_csv(path: str, trace: Sequence[JobTrace]) -> None:
    """Write a trace back out in the Philly-style column set (duration-
    profiled rows only — iteration-profiled rows have no runtime column)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(PHILLY_COLUMNS)
        for t in trace:
            if t.duration_s is None:
                raise ValueError(f"job {t.job_id} is iteration-profiled")
            w.writerow(
                [
                    t.job_id,
                    "prod" if t.priority == "production" else "research",
                    f"{t.arrival_s:.1f}",
                    t.num_gpus,
                    f"{t.duration_s:.1f}",
                    t.model,
                    "Pass",
                ]
            )


def philly_sample(path: Optional[str] = None) -> List[JobTrace]:
    """The committed sample file backing the ``philly-sample`` scenario."""
    return load_philly_csv(path or PHILLY_SAMPLE)


# --------------------------------------------------------------------------- #
# Fixture-backed loaders
# --------------------------------------------------------------------------- #
def shockwave_fixture(
    num_jobs: int, seed: int, profile: Optional[ThroughputProfile] = None
) -> List[JobTrace]:
    profile = profile or ThroughputProfile()
    return from_jobspecs(shockwave_trace(num_jobs=num_jobs, seed=seed, profile=profile))


def gavel_fixture(
    num_jobs: int, seed: int, profile: Optional[ThroughputProfile] = None
) -> List[JobTrace]:
    profile = profile or ThroughputProfile()
    return from_jobspecs(gavel_trace(num_jobs=num_jobs, seed=seed, profile=profile))
