"""Job model for the Tesserae scheduler.

A *job* is a DL training run requesting ``num_gpus`` accelerators for
``total_iters`` iterations.  Jobs are opaque to the matcher — all the
placement policies need is (a) the GPU count, (b) throughput profiles
(isolated / packed / per-parallelism-strategy), and (c) migration overheads
(checkpoint save+load + warmup, Fig. 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """Immutable description of a submitted job (one trace row)."""

    job_id: int
    model: str
    num_gpus: int
    total_iters: float
    arrival_time: float  # seconds since trace start
    batch_size: int = 32
    #: jobs with strict deadlines / high priority bypass packing (§4.3
    #: "Fairness": no edges are created for them in Algorithm 4).
    packable: bool = True
    #: 3D-parallel (Megatron-style) jobs expose a parallelism-strategy
    #: degree of freedom (§4.2 "Parallelism Strategy"); DDP jobs do not.
    is_llm: bool = False


@dataclasses.dataclass
class JobState:
    """Mutable per-job bookkeeping carried across scheduling rounds."""

    spec: JobSpec
    iters_done: float = 0.0
    #: 2D attained service = sum over rounds of num_gpus * executed seconds
    #: (Tiresias' LAS metric).
    attained_service: float = 0.0
    executed_time: float = 0.0
    first_run_time: Optional[float] = None
    finish_time: Optional[float] = None
    #: physical GPU ids currently assigned (empty when preempted/pending).
    gpus: frozenset = frozenset()
    #: job id this job is currently packed with (None = exclusive).
    packed_with: Optional[int] = None
    #: chosen parallelism strategy name (LLM jobs only).
    strategy: str = "dp"
    migrations: int = 0
    #: seconds of pending migration penalty still to pay off.
    migration_debt: float = 0.0
    # -- fault-injection bookkeeping (all inert on the failure-free path) -- #
    #: retries consumed (node crashes + job failures both count).
    retries: int = 0
    #: involuntary evictions suffered (node-down preemptions).
    preemptions: int = 0
    #: earliest time the job may be (re)placed — exponential backoff
    #: pushes this into the future after a failure.
    eligible_time: float = 0.0
    #: progress as of the last checkpoint; a crash rolls ``iters_done``
    #: back to this (the checkpoint-interval lost-work model).
    ckpt_iters: float = 0.0
    #: ``executed_time`` at the last checkpoint (drives the interval).
    ckpt_executed: float = 0.0
    #: ``attained_service`` at the last checkpoint.  A crash rewinds the
    #: LAS metric here too — the surviving checkpoint is all the service
    #: the job actually keeps, so Tiresias must not demote a crash victim
    #: for work that was lost.
    ckpt_service: float = 0.0
    #: cumulative iterations discarded by crash rollbacks.
    lost_iters: float = 0.0
    #: retry budget exhausted — terminally failed, never requeued.
    failed: bool = False

    @property
    def job_id(self) -> int:
        return self.spec.job_id

    @property
    def num_gpus(self) -> int:
        return self.spec.num_gpus

    @property
    def finished(self) -> bool:
        return self.finish_time is not None

    def remaining_iters(self) -> float:
        return max(0.0, self.spec.total_iters - self.iters_done)


# Migration overhead (checkpoint save + load + warmup, seconds) per model
# family, digitised from Fig. 3(a): vision/point-cloud models restart in tens
# of seconds, LLMs pay much more (optimizer state + pipeline warmup).
MIGRATION_OVERHEAD_S = {
    "resnet50": 25.0,
    "vgg19": 35.0,
    "dcgan": 20.0,
    "pointnet": 15.0,
    "gpt3-medium": 60.0,
    "gpt3-xl": 90.0,
    "gpt3-3b": 140.0,
}
_DEFAULT_MIGRATION_OVERHEAD_S = 45.0


def migration_overhead_s(model: str) -> float:
    return MIGRATION_OVERHEAD_S.get(model, _DEFAULT_MIGRATION_OVERHEAD_S)
