"""Themis finish-time-fairness (FTF) priority (Mahajan et al., NSDI'20).

FTF ratio rho = T_shared / T_fair where T_fair is the job's finish time in
an isolated cluster of 1/N-th the resources.  Themis runs an auction giving
GPUs to the jobs with the *worst* (largest) projected rho; as a priority
order that means sorting by descending rho estimate.
"""

from __future__ import annotations

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.jobs import JobState
from repro_torch.core.policies.base import SchedulingPolicy


class ThemisFtfPolicy(SchedulingPolicy):
    name = "ftf"

    def __init__(self, profile=None, avg_contention: float = 4.0):
        super().__init__(profile)
        #: running estimate of cluster contention (jobs per fair share);
        #: updated by the simulator each round.
        self.avg_contention = avg_contention

    def rho(self, job: JobState, now: float, cluster: ClusterSpec) -> float:
        tput = self.profile.isolated(job.spec.model, job.num_gpus, job.strategy)
        iso_total = job.spec.total_iters / max(tput, 1e-9)
        # T_fair: isolated duration stretched by contention for its share.
        t_fair = job.spec.arrival_time + iso_total * max(self.avg_contention, 1.0)
        remaining = job.remaining_iters() / max(tput, 1e-9)
        t_shared_proj = now + remaining
        return (t_shared_proj - job.spec.arrival_time) / max(
            t_fair - job.spec.arrival_time, 1e-9
        )

    def sort_key(self, job: JobState, now: float, cluster: ClusterSpec):
        return -self.rho(job, now, cluster)  # worst-off first
