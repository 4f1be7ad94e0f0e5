"""The one traffic generator: a traffic file's parameters -> a job trace.

A traffic file (``traffic/<name>.json``) states, per GPU of the cluster,
how many jobs are queued at t = 0 (``initial_jobs_per_gpu``) and at what
rate jobs arrive afterwards (``arrivals``), how long each runs alone at its
gang size (``durations``), its gang size (``gangs``), model and priority,
and for how many scheduling rounds the trace holds arrivals
(``trace_rounds``).  The arithmetic of the arrival processes and of the
duration and gang distributions is copied from
``src/repro_torch/workloads/generators.py`` (``Arrivals``, ``Durations``,
``GangSizes``) and the Shockwave class mix from
``src/repro_torch/core/traces.py`` (``_SHOCKWAVE_CLASSES``).

Every seed gets the same set of jobs and the same arrival times: both are
drawn from the file's ``base_seed``, and ``--seed`` only permutes which
job (duration, gang, model, batch, priority) arrives at which time after
the warm-up.  So the work a window sees does not depend on the seed's
luck, only on the order, and the state at the window's start (after the
warm-up's jobs, which every seed shares) is the same for every seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from tesserae_bench import tput

_H = 3600.0

#: Shockwave-like duration classes: probability, (lo, hi) seconds
SHOCKWAVE_CLASSES = (
    (0.72, (600.0, 3600.0)),
    (0.20, (3600.0, 3 * 3600.0)),
    (0.05, (3 * 3600.0, 8 * 3600.0)),
    (0.03, (8 * 3600.0, 16 * 3600.0)),
)


@dataclasses.dataclass(frozen=True)
class Job:
    """One trace row, the inputs handed to the program and the reference."""

    job_id: int
    model: str
    num_gpus: int
    arrival_s: float
    duration_s: float
    batch_size: int
    packable: bool

    @property
    def total_iters(self) -> float:
        return self.duration_s * tput.isolated(self.model, self.num_gpus)


def arrival_times(spec: Dict, rate_per_hour: float, horizon_s: float, rng) -> np.ndarray:
    """Arrival instants in (0, horizon_s): ``poisson`` or ``bursty`` (half
    the mean rate as background Poisson, half in a burst every
    ``burst_every_h`` hours spread over ``burst_spread_s``)."""
    kind = spec["kind"]
    if rate_per_hour <= 0:
        return np.zeros(0)
    if kind == "poisson":
        n = int(horizon_s / _H * rate_per_hour * 1.5) + 64
        t = np.cumsum(rng.exponential(_H / rate_per_hour, size=n))
        while t[-1] < horizon_s:
            t = np.concatenate([t, t[-1] + np.cumsum(rng.exponential(_H / rate_per_hour, size=n))])
        return t[t < horizon_s]
    if kind == "bursty":
        bg_rate = rate_per_hour / 2.0
        every_h = spec.get("burst_every_h", 3.0)
        spread = spec.get("burst_spread_s", 300.0)
        mean_burst = max(1, round(bg_rate * every_h))
        times: List[float] = []
        t_bg = 0.0
        while t_bg < horizon_s:
            t_bg += float(rng.exponential(_H / bg_rate))
            times.append(t_bg)
        t_burst = float(rng.uniform(0.0, every_h * _H))
        while t_burst < horizon_s:
            k = max(1, int(rng.poisson(mean_burst)))
            times.extend((t_burst + rng.uniform(0.0, spread, size=k)).tolist())
            t_burst += every_h * _H
        t = np.sort(np.asarray(times))
        return t[t < horizon_s]
    raise ValueError(f"unknown arrival kind {kind!r}")


def durations(spec: Dict, n: int, rng) -> np.ndarray:
    """Seconds alone at the job's gang size: ``pareto`` (scale
    ``median_s``, tail ``alpha``) or ``classes`` (the Shockwave mix),
    clipped into [min_s, cap_s]."""
    kind = spec["kind"]
    if kind == "pareto":
        d = spec["median_s"] * (1.0 + rng.pareto(spec["alpha"], size=n))
    elif kind == "classes":
        p = np.array([c[0] for c in SHOCKWAVE_CLASSES])
        k = rng.choice(len(p), size=n, p=p / p.sum())
        lo = np.array([c[1][0] for c in SHOCKWAVE_CLASSES])[k]
        hi = np.array([c[1][1] for c in SHOCKWAVE_CLASSES])[k]
        d = rng.uniform(lo, hi)
    else:
        raise ValueError(f"unknown duration kind {kind!r}")
    return np.clip(d, spec.get("min_s", 120.0), spec.get("cap_s", 4 * 24 * _H))


def gang_sizes(spec: Dict, n: int, rng) -> np.ndarray:
    p = np.asarray(spec["probs"], dtype=np.float64)
    return np.asarray(spec["sizes"])[rng.choice(len(p), size=n, p=p / p.sum())]


def horizon_s(traffic: Dict, round_s: float) -> float:
    """Simulated seconds the trace holds arrivals for."""
    return traffic["trace_rounds"] * round_s


def make_trace(traffic: Dict, num_gpus: int, seed: int, round_s: float) -> List[Job]:
    """The cell's jobs: the file's set; those arriving after the warm-up's
    ``warmup_rounds`` in the order ``seed`` draws."""
    base = np.random.default_rng(traffic["base_seed"])
    n0 = int(round(traffic["initial_jobs_per_gpu"] * num_gpus))
    arr = traffic["arrivals"]
    rate = arr["rate_per_gpu_hour"] * num_gpus
    times = np.concatenate(
        [np.zeros(n0), arrival_times(arr, rate, horizon_s(traffic, round_s), base)]
    )
    n = len(times)
    dur = durations(traffic["durations"], n, base)
    gang = gang_sizes(traffic["gangs"], n, base)
    models = traffic["models"]
    model = np.asarray(base.integers(0, len(models), size=n))
    batch = 16 * (2 ** base.integers(0, 4, size=n))
    prod = base.random(n) < traffic.get("production_fraction", 0.0)
    fixed = int(np.searchsorted(times, traffic["warmup_rounds"] * round_s))
    order = np.concatenate(
        [np.arange(fixed), fixed + np.random.default_rng(seed).permutation(n - fixed)]
    )
    return [
        Job(
            job_id=j,
            model=models[int(model[order[j]])],
            num_gpus=int(gang[order[j]]),
            arrival_s=float(times[j]),
            duration_s=float(dur[order[j]]),
            batch_size=int(batch[order[j]]),
            packable=not bool(prod[order[j]]),
        )
        for j in range(n)
    ]

