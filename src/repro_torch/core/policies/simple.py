"""FIFO and SRTF priority orders."""

from __future__ import annotations

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.jobs import JobState
from repro_torch.core.policies.base import SchedulingPolicy


class FifoPolicy(SchedulingPolicy):
    name = "fifo"

    def sort_key(self, job: JobState, now: float, cluster: ClusterSpec):
        return job.spec.arrival_time


class SrtfPolicy(SchedulingPolicy):
    """Shortest remaining (estimated) time first."""

    name = "srtf"

    def sort_key(self, job: JobState, now: float, cluster: ClusterSpec):
        tput = self.profile.isolated(job.spec.model, job.num_gpus, job.strategy)
        return job.remaining_iters() / max(tput, 1e-9)
