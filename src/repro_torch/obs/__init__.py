"""Unified observability layer: structured round tracing + metrics.

Opt-in (``obs=None`` everywhere by default) and provably inert: with obs
disabled every instrumented call site routes through no-op singletons
and the decision sequence is bit-identical to the uninstrumented path;
with obs enabled, only host-side Python bookkeeping runs — no device
reads, no decision inputs touched.

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
    to_obs_doc,
    validate_chrome_trace,
    validate_obs_doc,
    write_chrome_trace,
    write_obs_doc,
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
    "to_obs_doc",
    "validate_chrome_trace",
    "validate_obs_doc",
    "write_chrome_trace",
    "write_obs_doc",
]
