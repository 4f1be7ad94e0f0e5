"""The benchmark's frozen copy of the port's analytic throughput model.

Copied from ``src/repro_torch/core/profiler.py`` (``MODEL_CATALOG``,
``STRATEGIES``, ``_pair_hash_unit`` and ``ThroughputProfile``'s
``isolated`` / ``mem_gb`` / ``packable`` / ``normalized_packed`` /
``combined_weight``, the default A100 profile), so that the traffic
generator's iteration counts and the reference's packing weights stay
fixed while the program changes.  Plain Python and NumPy; it imports
nothing of the program.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np

#: name -> (compute intensity, GB per GPU, iterations/s on one A100, is_llm)
MODELS: Dict[str, Tuple[float, float, float, bool]] = {
    "resnet50": (0.82, 9.0, 6.0, False),
    "vgg19": (0.68, 15.0, 3.0, False),
    "dcgan": (0.45, 6.0, 14.0, False),
    "pointnet": (0.25, 4.0, 50.0, False),
    "gpt3-medium": (0.72, 17.0, 1.6, True),
    "gpt3-xl": (0.78, 25.0, 0.7, True),
    "gpt3-3b": (0.85, 33.0, 0.33, True),
}

#: parallelism strategy -> (throughput factor, memory factor) against DP
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

GPU_MEM_GB = 40.0  # A100
GPU_SPEED = 1.0
GAMMA = 0.12
JITTER = 0.05
STRATEGY_JITTER = 0.08


def _pair_hash_unit(a: str, b: str, salt: str = "") -> float:
    key = "|".join(sorted((a, b))) + "#" + salt
    h = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(h[:8], "little") / 2**64


def _strategy_factors(name: str, strategy: str) -> Tuple[float, float]:
    tput_f, mem_f = STRATEGIES[strategy]
    u = _pair_hash_unit(name, strategy, "strat")
    return tput_f * (1.0 + STRATEGY_JITTER * (2 * u - 1)), mem_f


def strategies(name: str) -> Tuple[str, ...]:
    return tuple(STRATEGIES) if MODELS[name][3] else ("dp",)


def isolated(name: str, num_gpus: int = 1, strategy: str = "dp") -> float:
    """Iterations per second, linear in the GPU count."""
    return MODELS[name][2] * GPU_SPEED * num_gpus * _strategy_factors(name, strategy)[0]


def mem_gb(name: str, strategy: str = "dp") -> float:
    return MODELS[name][1] * _strategy_factors(name, strategy)[1]


def normalized_packed(a: str, b: str, strat_a: str = "dp", strat_b: str = "dp"):
    """(a's, b's) packed throughput over their isolated throughput; (0, 0)
    where the pair does not fit in one GPU's memory."""
    if mem_gb(a, strat_a) + mem_gb(b, strat_b) > GPU_MEM_GB:
        return 0.0, 0.0
    ca, cb = MODELS[a][0], MODELS[b][0]
    overlap = ca * cb + (1 - ca) * (1 - cb)
    interference = GAMMA + (1 - GAMMA) * overlap
    mem_util = (mem_gb(a, strat_a) + mem_gb(b, strat_b)) / GPU_MEM_GB
    interference *= 0.55 + 0.75 * mem_util
    wiggle = 1.0 + JITTER * (2 * _pair_hash_unit(a, b) - 1)
    na = wiggle / (1.0 + interference)
    skew = 0.06 * (ca - cb)
    return (
        float(np.clip(na * (1 + skew), 0.05, 1.0)),
        float(np.clip(na * (1 - skew), 0.05, 1.0)),
    )


def combined_weight(a: str, b: str) -> float:
    """Algorithm 4's edge weight of placed job ``a`` and pending job ``b``:
    their summed normalised packed throughput, maximised over a's
    parallelism strategies."""
    best = 0.0
    dp = isolated(a, 1, "dp")
    for s in strategies(a):
        na, nb = normalized_packed(a, b, strat_a=s)
        w = isolated(a, 1, s) / dp * na + nb
        if w > best:
            best = w
    return best
