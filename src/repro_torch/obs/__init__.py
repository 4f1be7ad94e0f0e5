"""Unified observability layer: structured round tracing + metrics.

Opt-in (``obs=None`` everywhere by default) and provably inert: with obs
disabled every instrumented call site routes through no-op singletons
and the decision sequence is bit-identical to the uninstrumented path;
with obs enabled, host-side Python bookkeeping runs, and on CUDA a pair
of timing events around each timed kernel launch
(``repro_torch.device.device_timer``) — no added device read or
synchronisation, no decision inputs touched.

Entry point::

    from repro_torch.obs import Observability
    obs = Observability()
    sim = Simulator(..., obs=obs)          # or scheduler.decide(..., via obs=)
    sim.run()
    write_chrome_trace(obs.tracer, "trace.json")   # load in Perfetto
    obs.metrics.histogram("decide.latency_s").percentile(99)
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Observability,
)
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Span, Tracer, tracer_of
from repro_torch.obs.trace_export import (
    OBS_SCHEMA_VERSION,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Observability",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "tracer_of",
    "OBS_SCHEMA_VERSION",
    "to_chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
]
