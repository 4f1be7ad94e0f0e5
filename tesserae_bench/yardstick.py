"""The yardstick's arithmetic: the card's peaks, the kernels' least bytes,
nearest-rank percentiles and the union of device busy intervals.

Nothing here imports the program.  The copies name their originals.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

#: NVIDIA H100 SXM 80GB HBM3 at its 700 W limit, data sheet: HBM bytes/s.
#: Copied from ``src/repro_torch/roofline.py`` (``HBM_BW``); the run prints
#: the card's power limit beside its numbers.
HBM_BW = 3.35e12

#: job slots per GPU (``src/repro_torch/core/cluster.py`` ``MAX_PACK``)
MAX_PACK = 2


def lap_auction_bytes(b: int, n: int, m: int) -> int:
    """Least bytes of one ``lap_auction`` solve of a (B, n, m) f32 benefit:
    the benefit read once and the int32 assignment (B, n) written once.
    The same count whatever solves the LAP, so it does not follow the
    kernel's bid rounds."""
    return b * n * (4 * m + 4)


def migration_cost_bytes(u: int, v: int) -> int:
    """Least bytes of one ``migration_cost`` (K5) launch: each GPU's
    ``MAX_PACK`` int32 job ids and f64 weights read once, on both sides,
    and the f64 (U, V) matrix written once."""
    return (u + v) * MAX_PACK * (4 + 8) + 8 * u * v


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile, the ``ceil(p/100 * n)``-th smallest value.
    Copied from ``src/repro_torch/obs/metrics.py`` (``Histogram.percentile``)."""
    if not values:
        raise ValueError("percentile of no values")
    if not 0.0 < p <= 100.0:
        raise ValueError(f"percentile must be in (0, 100], got {p}")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(p / 100.0 * len(ordered))) - 1]


def union(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The busy intervals clipped to [lo, hi] and merged, in order."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi] between merged busy intervals."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out
