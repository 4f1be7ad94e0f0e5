"""Exporter for the observability layer: Chrome trace / Perfetto JSON.

:func:`to_chrome_trace` gives the ``traceEvents`` array of complete
(``"ph": "X"``) events that ``chrome://tracing`` and
https://ui.perfetto.dev load directly.  Timestamps and durations are
microseconds after the tracer's epoch, which ``otherData["epoch_s"]``
carries as a ``time.perf_counter()`` reading; span attributes ride in
``args``, and a span's device time, where a device timer measured it, in
``args["device_ms"]``.  :func:`validate_chrome_trace` checks the shape.
stdlib only.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.tracer import Span, Tracer

#: version tag of the exported trace (``otherData["schema"]``).
OBS_SCHEMA_VERSION = "tesserae-obs-v1"


def _emit_events(sp: Span, out: List[Dict[str, Any]]) -> None:
    ev: Dict[str, Any] = {
        "name": sp.name,
        "ph": "X",
        "ts": round(sp.t0 * 1e6, 3),
        "dur": round(sp.dur_s * 1e6, 3),
        "pid": 0,
        "tid": sp.tid,
    }
    args = {k: sp.attrs[k] for k in sorted(sp.attrs)}
    if sp.device_s is not None:
        args["device_ms"] = sp.device_s * 1e3
    if args:
        ev["args"] = args
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
        "otherData": {"schema": OBS_SCHEMA_VERSION, "epoch_s": tracer.epoch_s},
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
