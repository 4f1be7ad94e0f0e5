"""Counters, gauges and exact-observation histograms.

The registry is the single aggregation substrate for the simulator's
telemetry: per-round ``match_stats`` deltas, degradation-ladder tags,
fault/lost-work counters and decide-stage latencies all land here, and
``SimResult``'s legacy telemetry fields are *views* over it.

Histograms store every observation exactly (bounded by rounds-per-run,
so a few thousand floats at most) and compute nearest-rank percentiles —
p50/p95/p99 are exact order statistics, not bucket interpolations, which
is what lets the tests pin them on known distributions.

stdlib only; see :mod:`repro_torch.obs.tracer` for the contract.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, delta: int = 1) -> None:
        self.value += delta


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Exact-observation histogram with nearest-rank percentiles."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, value: float) -> None:
        self.values.append(float(value))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def total(self) -> float:
        return float(sum(self.values))

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile: the ``ceil(p/100 * n)``-th smallest
        observation (1-indexed).  Exact — e.g. over 1..100, p50 is 50.0,
        p95 is 95.0, p99 is 99.0.  Raises on an empty histogram."""
        if not self.values:
            raise ValueError(f"histogram {self.name!r} has no observations")
        if not 0.0 < p <= 100.0:
            raise ValueError(f"percentile must be in (0, 100], got {p}")
        ordered = sorted(self.values)
        rank = max(1, math.ceil(p / 100.0 * len(ordered)))
        return ordered[rank - 1]


class MetricsRegistry:
    """Get-or-create registry of named counters/gauges/histograms.

    Thread-safe creation (the prewarm thread may race the sim loop on
    first touch); increments on an existing instrument are plain int/list
    ops under the GIL, matching the single-writer-per-metric usage here.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- get-or-create -------------------------------------------------- #
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    # -- read-only views ------------------------------------------------ #
    def counter_value(self, name: str, default: int = 0) -> int:
        c = self._counters.get(name)
        return c.value if c is not None else default

    def counters_with_prefix(self, prefix: str) -> Dict[str, int]:
        """``{suffix: value}`` for every counter named ``prefix + suffix``."""
        return {
            name[len(prefix):]: c.value
            for name, c in self._counters.items()
            if name.startswith(prefix)
        }

    def histogram_values(self, name: str) -> List[float]:
        h = self._histograms.get(name)
        return list(h.values) if h is not None else []

    def reset(self) -> None:
        with self._lock:
            self._counters = {}
            self._gauges = {}
            self._histograms = {}


class Observability:
    """The bundle a caller passes down as ``obs=``: one tracer + one
    metrics registry, shared by the simulator, scheduler, fused planner
    and matching engine for the duration of a run."""

    def __init__(
        self,
        tracer: Optional["Tracer"] = None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        from repro_torch.obs.tracer import Tracer

        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    def reset(self) -> None:
        self.tracer.reset()
        self.metrics.reset()
