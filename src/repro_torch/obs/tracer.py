"""Structured span tracing for the scheduler's decision pipeline.

A :class:`Tracer` records a tree of named, attributed spans per thread:
``span("decide") > span("policy_sort") > span("migrate.fused") > ...``.
Span *structure* (names, nesting, attribute values, per-thread sequence)
is deterministic for a seeded run; wall-clock timings ride along but are
excluded from :meth:`Tracer.fingerprint` so two identical seeded runs
hash identically even though their timings differ.

Design constraints (the instrument-without-perturbing contract):

* **stdlib only** — this module must never import torch/numpy, so the obs
  layer cannot originate device work or device→host syncs.
* **monotonic clock only** — ``time.perf_counter`` (exempted by the
  ``det`` pass) is the sole time source; no wall-clock reads.
* **thread-correct** — the speculative-prewarm thread traces into its
  own root list via ``threading.local`` span stacks; tids are mapped to
  small stable ints in first-seen order (main thread is always 0).
* **no-op when disabled** — :data:`NULL_TRACER` swallows every call; the
  instrumented code paths take it by default so a run with ``obs=None``
  executes the identical decision sequence.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional


class Span:
    """One node of the span tree.  Attribute values must be JSON-safe
    (ints/floats/strs/bools/lists) — they are part of the deterministic
    fingerprint, so only put *decision-derived* values here, never
    wall-clock readings (timings live on the dedicated fields)."""

    __slots__ = ("name", "attrs", "children", "t0", "dur_s", "seq", "tid")

    def __init__(self, name: str, attrs: Dict[str, Any], seq: int, tid: int):
        self.name = name
        self.attrs = dict(attrs)
        self.children: List["Span"] = []
        self.t0 = 0.0
        self.dur_s = 0.0
        self.seq = seq
        self.tid = tid

    def annotate(self, **attrs: Any) -> None:
        """Attach attributes after the span opened (e.g. outcome counts
        known only once the stage finished)."""
        self.attrs.update(attrs)

    # -- deterministic view (no timings) ------------------------------- #
    def structure(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "tid": self.tid, "seq": self.seq}
        if self.attrs:
            d["attrs"] = {k: self.attrs[k] for k in sorted(self.attrs)}
        if self.children:
            d["children"] = [c.structure() for c in self.children]
        return d

    # -- full view (timings included) ---------------------------------- #
    def to_dict(self) -> Dict[str, Any]:
        d = self.structure()
        d["t0_s"] = self.t0
        d["dur_s"] = self.dur_s
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class _SpanContext:
    """Context manager opening/closing one span on the tracer."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        self._tracer._close(self._span)


class Tracer:
    """Collects nested spans across threads.

    Usage::

        with tracer.span("decide", round=3) as sp:
            with tracer.span("policy_sort"):
                ...
            sp.annotate(degrade="none")
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self._roots: List[Span] = []
        self._tids: Dict[int, int] = {threading.get_ident(): 0}
        self._seq = 0
        # epoch so exported timestamps are small offsets, not raw
        # perf_counter readings
        self._epoch = time.perf_counter()

    # ------------------------------------------------------------------ #
    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
            return self._tids[ident]

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs: Any) -> _SpanContext:
        with self._lock:
            seq = self._seq
            self._seq += 1
        sp = Span(name, attrs, seq, self._tid())
        sp.t0 = time.perf_counter() - self._epoch
        stack = self._stack()
        if stack:
            stack[-1].children.append(sp)
        else:
            with self._lock:
                self._roots.append(sp)
        stack.append(sp)
        return _SpanContext(self, sp)

    def _close(self, sp: Span) -> None:
        sp.dur_s = (time.perf_counter() - self._epoch) - sp.t0
        stack = self._stack()
        # close any children left open by an exception, then the span
        while stack and stack[-1] is not sp:
            stack.pop()
        if stack:
            stack.pop()

    # ------------------------------------------------------------------ #
    def roots(self) -> List[Span]:
        """Completed + in-flight root spans, ordered by (tid, seq) so the
        export is stable regardless of thread interleaving."""
        with self._lock:
            return sorted(self._roots, key=lambda s: (s.tid, s.seq))

    def structure(self) -> List[Dict[str, Any]]:
        """The deterministic (timing-free) span forest."""
        return [r.structure() for r in self.roots()]

    def fingerprint(self) -> str:
        """sha256 over the canonical JSON of the timing-free span forest.
        Equal across two identical seeded runs; any divergence in span
        names, nesting, attributes or per-thread ordering changes it."""
        blob = json.dumps(self.structure(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def reset(self) -> None:
        with self._lock:
            self._roots = []
            self._seq = 0
            self._tids = {threading.get_ident(): 0}
            self._epoch = time.perf_counter()


class _NullSpan:
    """Inert stand-in for :class:`Span` — every instrumentation point can
    unconditionally call ``annotate`` without an obs-enabled check."""

    __slots__ = ()

    def annotate(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


class NullTracer:
    """No-op tracer: the default wiring when observability is disabled.
    ``span(...)`` allocates nothing and records nothing, so the traced
    code path is byte-identical in behaviour to the uninstrumented one."""

    _NULL_SPAN = _NullSpan()

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        return self._NULL_SPAN

    def roots(self) -> List[Span]:
        return []

    def structure(self) -> List[Dict[str, Any]]:
        return []

    def fingerprint(self) -> str:
        return hashlib.sha256(b"[]").hexdigest()

    def reset(self) -> None:
        pass


#: module-level no-op singleton — instrumented call sites do
#: ``tracer = obs.tracer if obs is not None else NULL_TRACER``.
NULL_TRACER = NullTracer()


def tracer_of(obs: Optional[Any]):
    """The tracer of an ``Observability`` bundle, or :data:`NULL_TRACER`
    when obs is disabled (``None``) — the one-liner every instrumented
    module uses."""
    return obs.tracer if obs is not None else NULL_TRACER
