"""Exporters for the observability layer.

Two formats:

* **Chrome trace / Perfetto JSON** (:func:`to_chrome_trace`): the
  ``traceEvents`` array of complete (``"ph": "X"``) events that
  ``chrome://tracing`` and https://ui.perfetto.dev load directly.
  Timestamps/durations are microseconds relative to the tracer's epoch;
  span attributes ride in ``args``.

* **``tesserae-obs-v1``** (:func:`to_obs_doc`): the repo's own versioned
  envelope — schema version, the deterministic span-forest fingerprint,
  the full span forest (timings included) and a metrics snapshot.  The
  deterministic *subset* of the doc (fingerprint + structure + the
  non-timing metrics) is equal across identical seeded runs.

Both have matching ``validate_*`` functions used by the tests and the
obs-smoke CI lane.  stdlib only.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import Span, Tracer

#: version tag of the exported observability document.
OBS_SCHEMA_VERSION = "tesserae-obs-v1"


# ---------------------------------------------------------------------- #
# Chrome trace / Perfetto
# ---------------------------------------------------------------------- #
def _emit_events(sp: Span, out: List[Dict[str, Any]]) -> None:
    ev: Dict[str, Any] = {
        "name": sp.name,
        "ph": "X",
        "ts": round(sp.t0 * 1e6, 3),
        "dur": round(sp.dur_s * 1e6, 3),
        "pid": 0,
        "tid": sp.tid,
    }
    if sp.attrs:
        ev["args"] = {k: sp.attrs[k] for k in sorted(sp.attrs)}
    out.append(ev)
    for c in sp.children:
        _emit_events(c, out)


def to_chrome_trace(tracer: Tracer) -> Dict[str, Any]:
    events: List[Dict[str, Any]] = []
    for root in tracer.roots():
        _emit_events(root, events)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": OBS_SCHEMA_VERSION},
    }


def write_chrome_trace(tracer: Tracer, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer), f)


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Structural check that a Perfetto/chrome://tracing load will accept
    the document.  Returns a list of problems (empty = valid)."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: bad name")
        if ev.get("ph") != "X":
            problems.append(f"event {i}: ph != 'X'")
        for k in ("ts", "dur"):
            if not isinstance(ev.get(k), (int, float)) or ev[k] < 0:
                problems.append(f"event {i}: bad {k}")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                problems.append(f"event {i}: bad {k}")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"event {i}: args not an object")
    return problems


# ---------------------------------------------------------------------- #
# tesserae-obs-v1
# ---------------------------------------------------------------------- #
def to_obs_doc(tracer: Tracer, metrics: MetricsRegistry) -> Dict[str, Any]:
    return {
        "version": OBS_SCHEMA_VERSION,
        "fingerprint": tracer.fingerprint(),
        "spans": [r.to_dict() for r in tracer.roots()],
        "metrics": metrics.snapshot(),
        "deterministic_metrics": metrics.deterministic_snapshot(),
    }


def write_obs_doc(tracer: Tracer, metrics: MetricsRegistry, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_obs_doc(tracer, metrics), f)


def _check_span_dict(d: Any, where: str, problems: List[str]) -> None:
    if not isinstance(d, dict):
        problems.append(f"{where}: not an object")
        return
    if not isinstance(d.get("name"), str) or not d["name"]:
        problems.append(f"{where}: bad name")
    for k in ("tid", "seq"):
        if not isinstance(d.get(k), int):
            problems.append(f"{where}: bad {k}")
    for k in ("t0_s", "dur_s"):
        if not isinstance(d.get(k), (int, float)):
            problems.append(f"{where}: bad {k}")
    for i, c in enumerate(d.get("children", [])):
        _check_span_dict(c, f"{where}.children[{i}]", problems)


def validate_obs_doc(doc: Dict[str, Any]) -> List[str]:
    """Structural check of a ``tesserae-obs-v1`` document.  Returns a
    list of problems (empty = valid)."""
    problems: List[str] = []
    if doc.get("version") != OBS_SCHEMA_VERSION:
        problems.append(f"version != {OBS_SCHEMA_VERSION!r}")
    fp = doc.get("fingerprint")
    if not (isinstance(fp, str) and len(fp) == 64):
        problems.append("fingerprint missing or not a sha256 hex digest")
    spans = doc.get("spans")
    if not isinstance(spans, list):
        problems.append("spans missing or not a list")
    else:
        for i, sp in enumerate(spans):
            _check_span_dict(sp, f"spans[{i}]", problems)
    for key in ("metrics", "deterministic_metrics"):
        m = doc.get(key)
        if not isinstance(m, dict):
            problems.append(f"{key} missing or not an object")
            continue
        for section in ("counters", "gauges", "histograms"):
            if not isinstance(m.get(section), dict):
                problems.append(f"{key}.{section} missing or not an object")
    return problems
