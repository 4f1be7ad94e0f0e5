"""Scheduling-policy interface (Listing 1 line 3: "Sort active_jobs")."""

from __future__ import annotations

import abc
from typing import List, Sequence

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.jobs import JobState
from repro_torch.core.profiler import ThroughputProfile


class SchedulingPolicy(abc.ABC):
    """Produces the priority ORDER of active jobs; placement is Tesserae's."""

    name = "base"

    def __init__(self, profile: ThroughputProfile | None = None):
        self.profile = profile or ThroughputProfile()

    @abc.abstractmethod
    def sort_key(self, job: JobState, now: float, cluster: ClusterSpec):
        """Smaller key = higher priority."""

    def order(
        self, jobs: Sequence[JobState], now: float, cluster: ClusterSpec
    ) -> List[JobState]:
        # Stable sort; ties broken by arrival then id for determinism.
        return sorted(
            jobs,
            key=lambda j: (
                self.sort_key(j, now, cluster),
                j.spec.arrival_time,
                j.job_id,
            ),
        )
