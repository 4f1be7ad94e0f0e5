"""Throughput profiles and profiling-cost reducers (§4.2 "Profiling", §4.3).

The paper profiles every model / model-pair / parallelism-strategy offline
on real GPUs.  Without hardware we use an **analytic interference model**
grounded in roofline reasoning (DESIGN.md §3):

* every model has a *compute intensity* ``ci`` in (0, 1] — the fraction of
  its step time bound by the compute units rather than memory bandwidth.
  For the 10 assigned repro architectures the value is derived from the
  dry-run roofline terms (compute_term / (compute_term + memory_term));
  for the paper's Table-1 models we use representative constants.
* packing two jobs on one accelerator makes them contend for whichever
  resource both need: the normalised packed throughput of job *a* is
  ``1 / (1 + interference(a, b))`` with
  ``interference = gamma + (1 - gamma) * overlap`` and
  ``overlap = ci_a * ci_b + (1 - ci_a) * (1 - ci_b)``.
  Two compute-bound jobs each drop to ~0.5 (no packing gain); a
  compute-bound + memory-bound pair keeps ~0.85 each (combined ~1.7 —
  exactly the packing wins of Figs. 7/8).
* a pair is infeasible (OOM -> no edge in Algorithm 4) when the summed
  memory footprints exceed the accelerator HBM — this is what makes
  Tesserae adapt to V100s (less HBM => fewer packing opportunities,
  Fig. 12b) *without any retuning*.

Parallelism strategies (§4.2 "Parallelism Strategy"): LLM jobs carry a
candidate strategy set; each strategy has a throughput factor and a memory
factor (pipeline parallelism trades throughput for activation memory —
choosing it can turn an OOM pair feasible, as in Fig. 8's VGG-19 example).

Profiling-cost reducers (§4.3, Fig. 18): the linear scaling model for DP
jobs, Bayesian optimisation over the strategy space for LLM jobs, and the
matrix-completion baseline (Gavel/Quasar style).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------- #
# Catalog
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    ci: float            # compute intensity in (0, 1]
    mem_gb: float        # per-GPU training footprint at default strategy
    base_tput: float     # iters/sec on one reference (A100) GPU
    is_llm: bool = False


#: Table 1 models.  ci/mem grounded in public A100 measurements; base_tput
#: in iterations/second at the Table-1 batch sizes.
MODEL_CATALOG: Dict[str, ModelProfile] = {
    m.name: m
    for m in [
        ModelProfile("resnet50", ci=0.82, mem_gb=9.0, base_tput=6.0),
        ModelProfile("vgg19", ci=0.68, mem_gb=15.0, base_tput=3.0),
        ModelProfile("dcgan", ci=0.45, mem_gb=6.0, base_tput=14.0),
        ModelProfile("pointnet", ci=0.25, mem_gb=4.0, base_tput=50.0),
        ModelProfile("gpt3-medium", ci=0.72, mem_gb=17.0, base_tput=1.6, is_llm=True),
        ModelProfile("gpt3-xl", ci=0.78, mem_gb=25.0, base_tput=0.7, is_llm=True),
        ModelProfile("gpt3-3b", ci=0.85, mem_gb=33.0, base_tput=0.33, is_llm=True),
    ]
}


def register_model(
    name: str, ci: float, mem_gb: float, base_tput: float, is_llm: bool = False
) -> None:
    """Register extra models (the 10 assigned repro architectures plug in
    here with roofline-derived ci; see benchmarks/roofline_report.py)."""
    MODEL_CATALOG[name] = ModelProfile(name, ci, mem_gb, base_tput, is_llm)


@dataclasses.dataclass(frozen=True)
class GpuType:
    name: str
    mem_gb: float
    speed: float  # relative to A100


GPU_TYPES: Dict[str, GpuType] = {
    "a100": GpuType("a100", 40.0, 1.0),
    "v100": GpuType("v100", 16.0, 0.45),
    "tpu-v5e": GpuType("tpu-v5e", 16.0, 0.63),  # 197/312 bf16 TFLOP/s
}

#: Megatron-style strategy candidates (LLM jobs).  (tput_factor, mem_factor)
#: relative to pure DP.  "pp-default" is Megatron's uniform split; the
#: "pp-bal-*" entries are rebalanced splits like PP=(3,3,3,4,4,5,5,5) in
#: Fig. 8 — slightly better compute balance, much lower activation memory.
STRATEGIES: Dict[str, Tuple[float, float]] = {
    "dp": (1.00, 1.00),
    "tp": (0.92, 0.62),
    "pp-default": (0.84, 0.52),
    "pp-bal-1": (0.90, 0.50),
    "pp-bal-2": (0.94, 0.47),
    "pp-bal-3": (0.88, 0.44),
    "pp-deep": (0.80, 0.38),
    "tp-pp": (0.86, 0.40),
}
DP_ONLY = ("dp",)
LLM_STRATEGIES = tuple(STRATEGIES.keys())


def _pair_hash_unit(a: str, b: str, salt: str = "") -> float:
    """Deterministic pseudo-random unit float for a model pair."""
    key = "|".join(sorted((a, b))) + "#" + salt
    h = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(h[:8], "little") / 2**64


# --------------------------------------------------------------------------- #
# Ground-truth analytic profile
# --------------------------------------------------------------------------- #
class ThroughputProfile:
    """Analytic stand-in for the paper's offline profiling tables."""

    def __init__(
        self,
        gpu_type: str = "a100",
        gamma: float = 0.12,
        jitter: float = 0.05,
        strategy_jitter: float = 0.08,
    ):
        self.gpu = GPU_TYPES[gpu_type]
        self.gamma = gamma
        self.jitter = jitter
        self.strategy_jitter = strategy_jitter
        #: memo for combined_weight: the packing-graph build queries the
        #: same (model_a, model_b) pair thousands of times per round.
        self._weight_cache: Dict = {}

    def for_gpu_type(self, gpu_type: str) -> "ThroughputProfile":
        """Profile variant keyed to another GPU type (heterogeneous
        clusters: a job placed on a V100 node reads V100 speed and HBM).

        Returns ``self`` when the type already matches — the homogeneous
        path never allocates — and a cached plain
        :class:`ThroughputProfile` otherwise.  Wrapper subclasses
        (:class:`NoisyProfile`, :class:`TabulatedProfile`) intentionally
        degrade to the clean analytic profile for foreign types: their
        noise/tables were observed on the base type only.
        """
        if gpu_type == self.gpu.name:
            return self
        cache = self.__dict__.setdefault("_type_variants", {})
        hit = cache.get(gpu_type)
        if hit is None:
            hit = ThroughputProfile(
                gpu_type=gpu_type,
                gamma=self.gamma,
                jitter=self.jitter,
                strategy_jitter=self.strategy_jitter,
            )
            cache[gpu_type] = hit
        return hit

    # -- catalog helpers ------------------------------------------------- #
    def model(self, name: str) -> ModelProfile:
        try:
            return MODEL_CATALOG[name]
        except KeyError:
            raise KeyError(
                f"model {name!r} not in catalog; call profiler.register_model"
            ) from None

    def strategies(self, name: str) -> Tuple[str, ...]:
        return LLM_STRATEGIES if self.model(name).is_llm else DP_ONLY

    def _strategy_factors(self, name: str, strategy: str) -> Tuple[float, float]:
        tput_f, mem_f = STRATEGIES[strategy]
        # deterministic per-(model, strategy) wiggle so the "best" strategy
        # differs across models (the thing BO has to discover).
        u = _pair_hash_unit(name, strategy, "strat")
        tput_f *= 1.0 + self.strategy_jitter * (2 * u - 1)
        return tput_f, mem_f

    # -- isolated throughput --------------------------------------------- #
    def isolated(self, name: str, num_gpus: int = 1, strategy: str = "dp") -> float:
        """iters/sec.  Linear scaling in num_gpus (§4.3 linear model — the
        simulator's ground truth deliberately matches the paper's modelling
        assumption for DP jobs)."""
        m = self.model(name)
        tput_f, _ = self._strategy_factors(name, strategy)
        return m.base_tput * self.gpu.speed * num_gpus * tput_f

    def mem_gb(self, name: str, strategy: str = "dp") -> float:
        _, mem_f = self._strategy_factors(name, strategy)
        return self.model(name).mem_gb * mem_f

    # -- packed throughput ------------------------------------------------ #
    def packable(self, a: str, b: str, strat_a: str = "dp", strat_b: str = "dp") -> bool:
        return self.mem_gb(a, strat_a) + self.mem_gb(b, strat_b) <= self.gpu.mem_gb

    def normalized_packed(
        self, a: str, b: str, strat_a: str = "dp", strat_b: str = "dp"
    ) -> Tuple[float, float]:
        """(norm tput of a, norm tput of b) when packed on one accelerator.

        Normalised = packed tput / isolated tput at the same GPU count
        (§4.2 "Profiling").  Returns (0, 0) if the pair OOMs.
        """
        if not self.packable(a, b, strat_a, strat_b):
            return 0.0, 0.0
        ma, mb = self.model(a), self.model(b)
        overlap = ma.ci * mb.ci + (1 - ma.ci) * (1 - mb.ci)
        interference = self.gamma + (1 - self.gamma) * overlap
        # memory pressure: the fuller the HBM, the harsher the contention
        # (cache thrash / allocator fragmentation).  This is what makes
        # low-activation-memory parallelism strategies (PP/TP) raise PACKED
        # throughput even though they are slower in isolation (Fig. 8).
        mem_util = (
            self.mem_gb(a, strat_a) + self.mem_gb(b, strat_b)
        ) / self.gpu.mem_gb
        interference *= 0.55 + 0.75 * mem_util
        wiggle = 1.0 + self.jitter * (2 * _pair_hash_unit(a, b) - 1)
        na = wiggle / (1.0 + interference)
        nb = wiggle / (1.0 + interference)
        # packing asymmetry: the more memory-bound job suffers slightly more
        skew = 0.06 * (ma.ci - mb.ci)
        return float(np.clip(na * (1 + skew), 0.05, 1.0)), float(
            np.clip(nb * (1 - skew), 0.05, 1.0)
        )

    def combined_weight(
        self,
        a: str,
        b: str,
        optimize_strategy: bool = True,
        strategies_a: Optional[Sequence[str]] = None,
    ) -> Tuple[float, str]:
        """Edge weight for Algorithm 4: summed normalised packed throughput,
        maximised over the parallelism strategy of the *placed* job a
        (§4.2: "modify the edge weight ... when optimizing the parallelism
        strategy of job u")."""
        cands = tuple(
            strategies_a or (self.strategies(a) if optimize_strategy else ("dp",))
        )
        key = (a, b, cands)
        hit = self._weight_cache.get(key)
        if hit is not None:
            return hit
        best_w, best_s = 0.0, "dp"
        dp_tput = self.isolated(a, 1, "dp")
        for s in cands:
            na, nb = self.normalized_packed(a, b, strat_a=s)
            # job a's contribution is normalised to its DP-isolated rate, so
            # a slower-in-isolation strategy only wins when the packing gain
            # outweighs its throughput factor (Fig. 8's trade-off)
            rel = self.isolated(a, 1, s) / dp_tput
            w = rel * na + nb
            if w > best_w:
                best_w, best_s = w, s
        self._weight_cache[key] = (best_w, best_s)
        return best_w, best_s


# --------------------------------------------------------------------------- #
# Noise wrapper (Fig. 16) and estimators (Fig. 18)
# --------------------------------------------------------------------------- #
class RestrictedStrategyProfile(ThroughputProfile):
    """Limits the parallelism-strategy candidate set (Fig. 15 ablations:
    Tesserae-T (DP) / Tesserae-T (Default PP) / full Tesserae-T)."""

    def __init__(self, base: ThroughputProfile, allowed: Tuple[str, ...]):
        self.__dict__.update(base.__dict__)
        self._weight_cache = {}
        self._allowed = tuple(allowed)

    def strategies(self, name: str) -> Tuple[str, ...]:
        base = super().strategies(name)
        if not self.model(name).is_llm:
            return base
        out = tuple(s for s in base if s in self._allowed)
        return out or ("dp",)


class NoisyProfile(ThroughputProfile):
    """Multiplies packed-throughput lookups by U[1-n, 1+n] (§7.2)."""

    def __init__(self, base: ThroughputProfile, noise: float, seed: int = 0):
        self.__dict__.update(base.__dict__)
        self._weight_cache = {}
        self._noise = noise
        self._seed = seed

    def normalized_packed(self, a, b, strat_a="dp", strat_b="dp"):
        na, nb = super().normalized_packed(a, b, strat_a, strat_b)
        if na == 0.0:
            return na, nb
        u = _pair_hash_unit(a + strat_a, b + strat_b, f"noise{self._seed}")
        factor = 1.0 + self._noise * (2 * u - 1)
        return min(na * factor, 1.0), min(nb * factor, 1.0)


class TabulatedProfile(ThroughputProfile):
    """Profile whose packed table is *predicted* by an estimator.

    The scheduler reads this; the simulator advances jobs with the TRUE
    profile — mispredictions show up as bad packing choices (Fig. 18).
    """

    def __init__(self, base: ThroughputProfile, table: Dict[Tuple[str, str, str], Tuple[float, float]]):
        self.__dict__.update(base.__dict__)
        self._weight_cache = {}
        self._table = table
        self._base = base

    def normalized_packed(self, a, b, strat_a="dp", strat_b="dp"):
        key = (a, b, strat_a)
        if key in self._table:
            return self._table[key]
        rkey = (b, a, strat_b)
        if rkey in self._table:
            nb, na = self._table[rkey]
            return na, nb
        return self._base.normalized_packed(a, b, strat_a, strat_b)


def all_pairs(models: Sequence[str]) -> List[Tuple[str, str]]:
    return [(a, b) for i, a in enumerate(models) for b in models[i:]]


def oracle_table(
    profile: ThroughputProfile, models: Sequence[str]
) -> Dict[Tuple[str, str, str], Tuple[float, float]]:
    table = {}
    for a, b in all_pairs(models):
        for s in profile.strategies(a):
            table[(a, b, s)] = profile.normalized_packed(a, b, strat_a=s)
    return table


def linear_bo_estimate(
    profile: ThroughputProfile,
    models: Sequence[str],
    strategy_budget: int = 3,
    seed: int = 0,
) -> TabulatedProfile:
    """§4.3 profiling-cost reduction: profile each pair once at the default
    strategy ("linear model" observation), then spend ``strategy_budget``
    extra probes per LLM pair chosen by a tiny Bayesian-optimisation loop
    (GP with RBF kernel over a 2-feature strategy embedding, expected-
    improvement acquisition)."""
    rng = np.random.default_rng(seed)
    table: Dict[Tuple[str, str, str], Tuple[float, float]] = {}
    feats = {
        s: np.array([STRATEGIES[s][0], STRATEGIES[s][1]]) for s in STRATEGIES
    }
    for a, b in all_pairs(models):
        # one observation at the default strategy (cheap, always done)
        table[(a, b, "dp")] = profile.normalized_packed(a, b, strat_a="dp")
        if not profile.model(a).is_llm:
            continue
        cands = [s for s in profile.strategies(a) if s != "dp"]
        observed: Dict[str, float] = {"dp": sum(table[(a, b, "dp")])}
        for _ in range(strategy_budget):
            s = _bo_pick(observed, cands, feats, rng)
            if s is None:
                break
            na, nb = profile.normalized_packed(a, b, strat_a=s)
            table[(a, b, s)] = (na, nb)
            observed[s] = na + nb
        # predict un-probed strategies with the GP posterior mean
        mu = _gp_posterior_mean(observed, cands, feats)
        for s, m in mu.items():
            if (a, b, s) not in table:
                half = max(m, 0.0) / 2.0
                table[(a, b, s)] = (half, half)
    return TabulatedProfile(profile, table)


def matrix_completion_estimate(
    profile: ThroughputProfile,
    models: Sequence[str],
    observed_fraction: float = 0.4,
    rank: int = 2,
    seed: int = 0,
    iters: int = 200,
) -> TabulatedProfile:
    """Gavel/Quasar-style baseline: observe a random subset of the pairwise
    combined-throughput matrix and complete it with rank-``rank`` soft
    impute (alternating SVD)."""
    rng = np.random.default_rng(seed)
    n = len(models)
    truth = np.zeros((n, n))
    for i, a in enumerate(models):
        for j, b in enumerate(models):
            na, nb = profile.normalized_packed(a, b)
            truth[i, j] = na + nb
    mask = rng.random((n, n)) < observed_fraction
    mask |= mask.T
    np.fill_diagonal(mask, True)
    x = np.where(mask, truth, truth[mask].mean() if mask.any() else 1.0)
    for _ in range(iters):
        u, s, vt = np.linalg.svd(x, full_matrices=False)
        s[rank:] = 0.0
        x_low = (u * s) @ vt
        x = np.where(mask, truth, x_low)
    table: Dict[Tuple[str, str, str], Tuple[float, float]] = {}
    for i, a in enumerate(models):
        for j, b in enumerate(models):
            if j < i:
                continue
            w = float(np.clip(x[i, j], 0.0, 2.0))
            table[(a, b, "dp")] = (w / 2.0, w / 2.0)
    return TabulatedProfile(profile, table)


# -- tiny GP utilities ------------------------------------------------------ #
def _rbf(x1: np.ndarray, x2: np.ndarray, ls: float = 0.35) -> np.ndarray:
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / ls**2)


def _gp_fit(observed: Dict[str, float], feats: Dict[str, np.ndarray]):
    names = list(observed)
    x = np.stack([feats[s] for s in names])
    y = np.array([observed[s] for s in names])
    y_mean = y.mean()
    k = _rbf(x, x) + 1e-6 * np.eye(len(names))
    alpha = np.linalg.solve(k, y - y_mean)
    return x, alpha, y_mean


def _gp_posterior_mean(observed, cands, feats) -> Dict[str, float]:
    if not observed:
        return {s: 1.0 for s in cands}
    x, alpha, y_mean = _gp_fit(observed, feats)
    out = {}
    for s in cands:
        ks = _rbf(feats[s][None, :], x)[0]
        out[s] = float(y_mean + ks @ alpha)
    return out


def _bo_pick(observed, cands, feats, rng) -> Optional[str]:
    remaining = [s for s in cands if s not in observed]
    if not remaining:
        return None
    x, alpha, y_mean = _gp_fit(observed, feats)
    best = max(observed.values())
    scores = {}
    for s in remaining:
        ks = _rbf(feats[s][None, :], x)[0]
        mu = y_mean + float(ks @ alpha)
        var = max(1.0 - float(ks @ np.linalg.solve(_rbf(x, x) + 1e-6 * np.eye(len(x)), ks)), 1e-9)
        sigma = np.sqrt(var)
        z = (mu - best) / sigma
        # expected improvement
        from math import erf, exp, pi, sqrt

        phi = 0.5 * (1 + erf(z / sqrt(2)))
        pdf = exp(-0.5 * z * z) / sqrt(2 * pi)
        scores[s] = (mu - best) * phi + sigma * pdf
    return max(scores, key=scores.get)
