"""Workload trace generators (§6.1 "Traces" and §7.2 "Sensitivity").

Two families, matching the paper's evaluation:

* **Shockwave-like** (default): job *size class* probabilities
  Small/Medium/Large/XL = 0.72 / 0.20 / 0.05 / 0.03 and GPU-count
  probabilities 1/2/4/8 = 0.60 / 0.30 / 0.09 / 0.01; Poisson arrivals at 80
  jobs/hour.  120 jobs for "physical"-scale runs, 900 for simulation.
* **Gavel-like** (Fig. 17): durations 10^U[1.5,3] minutes w.p. 0.8 else
  10^U[3,4] minutes; GPU counts 1/2/4/8 = 0.70 / 0.10 / 0.15 / 0.05.

Models are drawn from the paper's Table 1; ``extra_models`` lets callers mix
in the 10 assigned repro architectures (used by examples/cluster_sim.py) so
Tesserae schedules the same models the JAX substrate trains.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.jobs import JobSpec
from repro_torch.core.profiler import MODEL_CATALOG, ThroughputProfile

TABLE1_MODELS = [
    "resnet50",
    "vgg19",
    "dcgan",
    "pointnet",
    "gpt3-medium",
    "gpt3-xl",
    "gpt3-3b",
]

#: duration classes (isolated runtime on ONE reference GPU, seconds)
_SHOCKWAVE_CLASSES = {
    "small": (0.72, (600.0, 3600.0)),
    "medium": (0.20, (3600.0, 3 * 3600.0)),
    "large": (0.05, (3 * 3600.0, 8 * 3600.0)),
    "xl": (0.03, (8 * 3600.0, 16 * 3600.0)),
}
_SHOCKWAVE_GPUS = ([1, 2, 4, 8], [0.60, 0.30, 0.09, 0.01])
_GAVEL_GPUS = ([1, 2, 4, 8], [0.70, 0.10, 0.15, 0.05])


def iters_for_duration(
    model: str, num_gpus: int, duration_s: float, profile: ThroughputProfile
) -> float:
    """Iteration count that runs for ``duration_s`` at the job's own GPU
    count (linear scaling) — the one conversion rule shared by these
    fixture generators and the :mod:`repro_torch.workloads` trace schema, so a
    duration-profiled trace row materialises identically everywhere."""
    return duration_s * profile.isolated(model, num_gpus)


def _mk_job(
    rng: np.random.Generator,
    job_id: int,
    arrival: float,
    duration_s: float,
    num_gpus: int,
    models: Sequence[str],
    profile: ThroughputProfile,
) -> JobSpec:
    model = models[int(rng.integers(len(models)))]
    is_llm = MODEL_CATALOG[model].is_llm
    total_iters = iters_for_duration(model, num_gpus, duration_s, profile)
    batch_pow = int(rng.integers(0, 4))
    return JobSpec(
        job_id=job_id,
        model=model,
        num_gpus=num_gpus,
        total_iters=total_iters,
        arrival_time=arrival,
        batch_size=16 * (2**batch_pow),
        packable=True,
        is_llm=is_llm,
    )


def shockwave_trace(
    num_jobs: int = 900,
    arrival_rate_per_hour: float = 80.0,
    seed: int = 0,
    models: Optional[Sequence[str]] = None,
    extra_models: Sequence[str] = (),
    profile: Optional[ThroughputProfile] = None,
) -> List[JobSpec]:
    rng = np.random.default_rng(seed)
    profile = profile or ThroughputProfile()
    models = list(models or TABLE1_MODELS) + list(extra_models)
    class_names = list(_SHOCKWAVE_CLASSES)
    class_p = np.array([_SHOCKWAVE_CLASSES[c][0] for c in class_names])
    class_p = class_p / class_p.sum()
    gpu_choices, gpu_p = _SHOCKWAVE_GPUS

    jobs: List[JobSpec] = []
    t = 0.0
    for jid in range(num_jobs):
        t += rng.exponential(3600.0 / arrival_rate_per_hour)
        cname = class_names[int(rng.choice(len(class_names), p=class_p))]
        lo, hi = _SHOCKWAVE_CLASSES[cname][1]
        duration = float(rng.uniform(lo, hi))
        g = int(rng.choice(gpu_choices, p=gpu_p))
        jobs.append(_mk_job(rng, jid, t, duration, g, models, profile))
    return jobs


def gavel_trace(
    num_jobs: int = 900,
    arrival_rate_per_hour: float = 80.0,
    seed: int = 0,
    models: Optional[Sequence[str]] = None,
    extra_models: Sequence[str] = (),
    profile: Optional[ThroughputProfile] = None,
) -> List[JobSpec]:
    rng = np.random.default_rng(seed)
    profile = profile or ThroughputProfile()
    models = list(models or TABLE1_MODELS) + list(extra_models)
    gpu_choices, gpu_p = _GAVEL_GPUS

    jobs: List[JobSpec] = []
    t = 0.0
    for jid in range(num_jobs):
        t += rng.exponential(3600.0 / arrival_rate_per_hour)
        if rng.random() < 0.8:
            duration = 60.0 * 10 ** rng.uniform(1.5, 3.0)
        else:
            duration = 60.0 * 10 ** rng.uniform(3.0, 4.0)
        g = int(rng.choice(gpu_choices, p=gpu_p))
        jobs.append(_mk_job(rng, jid, t, float(duration), g, models, profile))
    return jobs


def synthetic_active_jobs(
    num_jobs: int,
    seed: int = 0,
    models: Optional[Sequence[str]] = None,
    gpu_dist=_SHOCKWAVE_GPUS,
    profile: Optional[ThroughputProfile] = None,
):
    """Instant snapshot of `num_jobs` active jobs (for the Fig. 2 / Fig. 14
    decision-time scalability benchmark, which measures one round)."""
    from repro_torch.core.jobs import JobState

    rng = np.random.default_rng(seed)
    profile = profile or ThroughputProfile()
    models = list(models or TABLE1_MODELS)
    gpu_choices, gpu_p = gpu_dist
    out = []
    for jid in range(num_jobs):
        g = int(rng.choice(gpu_choices, p=gpu_p))
        spec = _mk_job(rng, jid, 0.0, float(rng.uniform(600, 3600 * 8)), g, models, profile)
        st = JobState(spec=spec)
        st.attained_service = float(rng.uniform(0, 3600 * 8)) * g
        out.append(st)
    return out
