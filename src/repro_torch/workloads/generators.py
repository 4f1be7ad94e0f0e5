"""Seeded, composable synthetic workload generators.

The datacenter characterisations behind the paper's evaluation (Philly,
Helios, PAI — "Deep Learning Workload Scheduling in GPU Datacenters" and
"Characterization and Prediction of Deep Learning Workloads") agree on
three properties the hand-rolled fixtures in :mod:`repro_torch.core.traces`
under-represent:

* **arrival processes** are not stationary Poisson: submission rates swing
  diurnally (3-5x peak/trough) and burst (gang submissions, sweep scripts,
  retry storms);
* **durations** are heavy-tailed: most jobs run minutes, a Pareto tail
  runs days and dominates GPU-time;
* **gang sizes** are skewed: single-GPU jobs dominate counts, 8+-GPU gangs
  dominate occupancy.

Each axis is a small frozen spec with a ``sample`` method; a
:class:`TraceRecipe` composes one of each into a full generator, and
:func:`generate_trace` materialises it deterministically from a seed.  The
same ``(recipe, num_jobs, seed)`` always yields the identical trace —
that is what makes scenario sweeps reproducible and lets CI gate on
determinism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.profiler import ThroughputProfile
from repro_torch.core.traces import TABLE1_MODELS
from repro_torch.workloads.schema import JobTrace

_H = 3600.0


# --------------------------------------------------------------------------- #
# Arrival processes
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Arrivals:
    """Arrival-time generator.

    ``kind``:

    * ``"poisson"`` — homogeneous Poisson at ``rate_per_hour``;
    * ``"diurnal"`` — inhomogeneous Poisson (thinning) with sinusoidal
      rate, ``peak_ratio`` = peak/trough, period ``period_h`` hours, the
      trough at t=0 (clusters fill over the working day);
    * ``"bursty"`` — background Poisson carrying half the mean rate, plus
      a clustered burst every ``burst_every_h`` hours spread over
      ``burst_spread_s`` (sweep scripts / gang retries).  ``burst_size``
      0 (default) sizes bursts to carry the other half of the rate
      budget, so the realised mean rate matches ``rate_per_hour``.
    """

    kind: str = "poisson"
    rate_per_hour: float = 80.0
    peak_ratio: float = 4.0
    period_h: float = 24.0
    burst_every_h: float = 3.0
    burst_size: int = 0
    burst_spread_s: float = 300.0

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "poisson":
            gaps = rng.exponential(_H / self.rate_per_hour, size=n)
            return np.cumsum(gaps)
        if self.kind == "diurnal":
            return self._diurnal(rng, n)
        if self.kind == "bursty":
            return self._bursty(rng, n)
        raise ValueError(f"unknown arrival kind {self.kind!r}")

    def _rate_at(self, t_s: np.ndarray) -> np.ndarray:
        """Diurnal rate (jobs/hour) at time t: mean ``rate_per_hour``,
        peak/trough ratio ``peak_ratio``."""
        a = (self.peak_ratio - 1.0) / (self.peak_ratio + 1.0)
        phase = 2.0 * math.pi * t_s / (self.period_h * _H)
        return self.rate_per_hour * (1.0 - a * np.cos(phase))

    def _diurnal(self, rng: np.random.Generator, n: int) -> np.ndarray:
        peak = self.rate_per_hour * 2.0 * self.peak_ratio / (self.peak_ratio + 1.0)
        out = np.empty(n)
        t, got = 0.0, 0
        while got < n:
            t += float(rng.exponential(_H / peak))
            if rng.random() * peak <= float(self._rate_at(np.array(t))):
                out[got] = t
                got += 1
        return out

    def _bursty(self, rng: np.random.Generator, n: int) -> np.ndarray:
        # background pays for half the mean rate, bursts for the other half
        bg_rate = self.rate_per_hour / 2.0
        mean_burst = self.burst_size or max(
            1, round(bg_rate * self.burst_every_h)
        )
        times: List[float] = []
        t_bg = 0.0
        horizon = n * _H / self.rate_per_hour * 4.0 + _H
        while t_bg < horizon:
            t_bg += float(rng.exponential(_H / bg_rate))
            times.append(t_bg)
        t_burst = float(rng.uniform(0.0, self.burst_every_h * _H))
        while t_burst < horizon:
            k = max(1, int(rng.poisson(mean_burst)))
            times.extend(
                (t_burst + rng.uniform(0.0, self.burst_spread_s, size=k)).tolist()
            )
            t_burst += self.burst_every_h * _H
        times.sort()
        return np.asarray(times[:n])


# --------------------------------------------------------------------------- #
# Duration distributions
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Durations:
    """Isolated-runtime generator (seconds, at the job's own gang size).

    ``kind``: ``"lognormal"`` (median ``median_s``, shape ``sigma``),
    ``"pareto"`` (scale ``min_s``, tail index ``alpha`` — the heavy tail
    of the Philly/Helios characterisations), or ``"loguniform"``
    (``10^U[log10 lo, log10 hi]`` minutes — the Gavel generator's shape).
    All kinds clip into ``[min_s, cap_s]``.
    """

    kind: str = "lognormal"
    median_s: float = 1800.0
    sigma: float = 1.6
    alpha: float = 1.2
    min_s: float = 120.0
    cap_s: float = 4.0 * 24.0 * _H

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "lognormal":
            d = self.median_s * np.exp(self.sigma * rng.standard_normal(n))
        elif self.kind == "pareto":
            d = self.median_s * (1.0 + rng.pareto(self.alpha, size=n))
        elif self.kind == "loguniform":
            lo, hi = np.log10(self.min_s), np.log10(self.cap_s)
            d = 10.0 ** rng.uniform(lo, hi, size=n)
        else:
            raise ValueError(f"unknown duration kind {self.kind!r}")
        return np.clip(d, self.min_s, self.cap_s)


# --------------------------------------------------------------------------- #
# Gang sizes, models, priority mix
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GangSizes:
    """Gang-size (GPU count) distribution; defaults to the Philly-style
    skew where single-GPU jobs dominate counts."""

    sizes: Tuple[int, ...] = (1, 2, 4, 8)
    probs: Tuple[float, ...] = (0.60, 0.25, 0.10, 0.05)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        p = np.asarray(self.probs, dtype=np.float64)
        return np.asarray(self.sizes)[rng.choice(len(self.sizes), size=n, p=p / p.sum())]


@dataclasses.dataclass(frozen=True)
class TraceRecipe:
    """One synthetic workload = arrivals x durations x gangs x models
    (+ a production-priority fraction whose jobs bypass packing)."""

    arrivals: Arrivals = Arrivals()
    durations: Durations = Durations()
    gangs: GangSizes = GangSizes()
    models: Tuple[str, ...] = tuple(TABLE1_MODELS)
    production_fraction: float = 0.0


def generate_trace(
    recipe: TraceRecipe,
    num_jobs: int,
    seed: int,
    profile: Optional[ThroughputProfile] = None,
) -> List[JobTrace]:
    """Materialise ``num_jobs`` trace rows, deterministically in ``seed``.

    Durations are kept as durations (the schema converts through the
    profile at :meth:`JobTrace.to_jobspec` time), so the same recipe can
    be re-profiled on different hardware without regenerating.  The
    ``profile`` argument exists only for signature compatibility with the
    fixture loaders — generation itself never consults it.
    """
    del profile  # duration-profiled rows; materialisation converts later
    rng = np.random.default_rng(seed)
    arrivals = recipe.arrivals.sample(rng, num_jobs)
    durations = recipe.durations.sample(rng, num_jobs)
    gangs = recipe.gangs.sample(rng, num_jobs)
    models = [
        recipe.models[int(k)]
        for k in rng.integers(0, len(recipe.models), size=num_jobs)
    ]
    batch = 16 * (2 ** rng.integers(0, 4, size=num_jobs))
    prod = rng.random(num_jobs) < recipe.production_fraction
    return [
        JobTrace(
            job_id=j,
            model=models[j],
            num_gpus=int(gangs[j]),
            arrival_s=float(arrivals[j]),
            duration_s=float(durations[j]),
            priority="production" if prod[j] else "best-effort",
            batch_size=int(batch[j]),
        )
        for j in range(num_jobs)
    ]
