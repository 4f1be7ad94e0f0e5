"""Tiresias 2D-LAS (Gu et al., NSDI'19).

Priority = least attained service, where service is the two-dimensional
product GPUs x executed-time.  Tiresias discretises service into queues to
avoid thrashing; we keep the discretisation (log-spaced thresholds) so jobs
within a queue are FIFO-ordered, exactly the behaviour the paper's
baselines exercise.
"""

from __future__ import annotations

import math

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.jobs import JobState
from repro_torch.core.policies.base import SchedulingPolicy


class TiresiasPolicy(SchedulingPolicy):
    name = "tiresias"

    #: queue thresholds in GPU-seconds (log spaced; first queue ~ 1 GPU-hour)
    def __init__(self, profile=None, queue_base: float = 3600.0, num_queues: int = 5):
        super().__init__(profile)
        self.queue_base = queue_base
        self.num_queues = num_queues

    def queue_of(self, service: float) -> int:
        if service <= 0:
            return 0
        q = int(math.floor(math.log2(service / self.queue_base) + 1))
        return max(0, min(q, self.num_queues - 1))

    def sort_key(self, job: JobState, now: float, cluster: ClusterSpec):
        q = self.queue_of(job.attained_service)
        # within a queue: FIFO by arrival (2D-LAS demotes as service grows)
        return (q, job.spec.arrival_time)
