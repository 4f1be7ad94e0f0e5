"""The reader of ``lap_exact_wait_ms`` on hand-made spans: the per-round sum
of the ``lap.fallback`` spans' ``wait_ms`` where they carry one, and
``None`` (never an error) on a program whose fallback carries none."""

import pytest

from tesserae_bench import harness

from test_bench_span_readers import ctx_of, sp, window


def _fallback_window(waits):
    """One round per entry of ``waits``, whose packing solve has a
    ``lap.fallback`` with that ``wait_ms`` (None: a fallback without it)."""
    roots = []
    for w in waits:
        attrs = {} if w is None else dict(ahead=1, wait_ms=w)
        fb = sp("lap.fallback", instances=1, **attrs)
        pack = sp("lap.solve", 30, children=[sp("lap.prepare"), sp("lap.check"), fb],
                  family="packing")
        roots.append(sp("round", children=[sp("decide", children=[sp("pack", children=[pack])])]))
    return ctx_of(roots, rounds=len(waits))


def test_exact_wait_sums_the_fallback_joins_per_round():
    read = harness.load_module("metrics", "lap_exact_wait_ms").read
    assert read(_fallback_window([0.5, 2.0])) == pytest.approx((0.5 + 2.0) / 2)
    assert read(_fallback_window([None, None])) is None  # no ``wait_ms``: the parent
    assert read(window()) is None  # no ``lap.fallback`` at all
    assert read(ctx_of([])) is None
