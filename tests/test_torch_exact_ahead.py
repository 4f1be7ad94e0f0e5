"""The exact re-solve started ahead: an instance whose last solve adopted
the exact answer gets its re-solve started on a host worker before the
auction, and the fallback takes that answer.  It must change nothing.

Packing-shaped replays (``tests/torch_rect_replay.py``) through both
packages' ``solve_lap_batched``: every result field and every context stat
equal the JAX engine's, while ``engine.exact_ahead`` counts what the worker
started, what the fallback used and what it dropped.
"""

import threading

import numpy as np
import pytest

from repro.core.matching import engine as jx
from repro_torch.core.matching import engine as tx
from repro_torch.obs import Observability
from tests.test_torch_engine import _solve_both
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)
from torch_rect_replay import packing_replay, stale_prices

KW = dict(backend="auction", maximize=True, context_key="packing")


def _stale_both(ctx_j, ctx_t, instances=None):
    """Stale high prices on the last auction's unassigned columns, the same
    in both contexts (their entries' assignments are equal)."""
    (ej,) = ctx_j._entries.values()
    (et,) = ctx_t._entries.values()
    np.testing.assert_array_equal(ej.col_solve, et.col_solve)
    ej.prices = stale_prices(ej.prices, ej.col_solve, instances)
    et.prices = stale_prices(et.prices, et.col_solve, instances)


def _ahead_delta(before):
    return {k: v - before[k] for k, v in vars(tx.exact_ahead).items()}


@pytest.mark.parametrize("seed", [1, 4])
def test_warm_rounds_take_the_answer_started_ahead(seed):
    """One cold round, then five warm rounds whose certificate fails and
    whose exact answer is adopted: from the second adoption on, each
    round's re-solve comes from the worker."""
    ctx_j, ctx_t = jx.MatchContext(), tx.MatchContext(device="cpu")
    for k, (costs, inst, rows, cols) in enumerate(packing_replay(seed, 6, 5, 14)):
        if k:
            _stale_both(ctx_j, ctx_t)
        before = dict(vars(tx.exact_ahead))
        _, rt = _solve_both(ctx_j, ctx_t, costs, inst, rows, cols, **KW)
        assert rt.used_fallback[0] == (k >= 1)
        engaged = int(k >= 2)
        assert _ahead_delta(before) == dict(started=engaged, used=engaged, dropped=0)
    assert ctx_t.stats["cert_violations"] == 5


@pytest.mark.parametrize("miss", ["certificate_passes", "memo_hit"])
def test_a_missed_prediction_is_dropped(miss):
    ctx_j, ctx_t = jx.MatchContext(), tx.MatchContext(device="cpu")
    rounds = packing_replay(1, 2, 5, 14)
    for k, (costs, inst, rows, cols) in enumerate(rounds):
        if k:
            _stale_both(ctx_j, ctx_t)
        _, rt = _solve_both(ctx_j, ctx_t, costs, inst, rows, cols, **KW)
    assert rt.used_fallback[0]
    costs, inst, rows, cols = rounds[-1]
    if miss == "certificate_passes":
        # every job new: the warm start carries no price, so the solve is
        # cold and its certificate holds
        costs, inst, rows, cols = packing_replay(5, 1, 5, 14)[0]
        rows, cols = rows + 10_000, cols + 10_000
    before = dict(vars(tx.exact_ahead))
    _, rt = _solve_both(ctx_j, ctx_t, costs, inst, rows, cols, **KW)
    assert not rt.used_fallback[0] if miss == "certificate_passes" else rt.used_fallback[0]
    assert _ahead_delta(before) == dict(started=1, used=0, dropped=1)


def test_early_and_synchronous_solves_mix_in_one_fallback():
    """Four rectangles.  In the first warm round instances 0 and 1 are
    staled and adopt the exact answer, and instance 3 is unchanged, so it
    memo-hits and keeps its cold round's flags.  In the next, 1 and 3 are
    staled: the ``lap.fallback`` joins the worker for the predicted
    instances that fail their certificate and solves 3 itself, in one
    call."""
    ctx_j, ctx_t = jx.MatchContext(), tx.MatchContext(device="cpu")
    ctx_t.obs = Observability()
    rounds = packing_replay(2, 3, 6, 40, batch=4)
    for a, b in zip(rounds[1], rounds[0]):
        a[3] = b[3]
    stale = [None, [0, 1], [1, 3]]
    for k, (costs, inst, rows, cols) in enumerate(rounds):
        if k:
            _stale_both(ctx_j, ctx_t, stale[k])
        before = dict(vars(tx.exact_ahead))
        _, rt = _solve_both(ctx_j, ctx_t, costs, inst, rows, cols, **KW)
        if k == 1:
            predicted = rt.used_fallback.copy()
    assert predicted[:2].all() and not predicted[3]
    fb = [s for s in ctx_t.obs.tracer.roots() if s.name == "lap.solve"][-1].children
    (fb,) = [s.attrs for s in fb if s.name == "lap.fallback"]
    assert 1 <= fb["ahead"] < fb["instances"] and fb["wait_ms"] >= 0.0
    started = int(predicted.sum())
    assert _ahead_delta(before) == dict(
        started=started, used=fb["ahead"], dropped=started - fb["ahead"]
    )
    assert rt.used_fallback[3]


def test_an_error_in_the_worker_surfaces_from_the_solve(monkeypatch):
    ctx_t = tx.MatchContext(device="cpu")
    rounds = packing_replay(1, 3, 5, 14)
    for k, (costs, inst, rows, cols) in enumerate(rounds[:2]):
        if k:
            (et,) = ctx_t._entries.values()
            et.prices = stale_prices(et.prices, et.col_solve)
        res = tx.solve_lap_batched(
            costs, context=ctx_t, instance_ids=inst, row_ids=rows, col_ids=cols, **KW
        )
    assert res.used_fallback[0]
    exact = tx._BACKENDS["scipy"]

    def off_the_main_thread_fails(benefit, eps_min, max_iters):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("exact solve failed on the worker")
        return exact(benefit, eps_min, max_iters)

    monkeypatch.setitem(tx._BACKENDS, "scipy", off_the_main_thread_fails)
    (et,) = ctx_t._entries.values()
    et.prices = stale_prices(et.prices, et.col_solve)
    costs, inst, rows, cols = rounds[2]
    with pytest.raises(RuntimeError, match="on the worker"):
        tx.solve_lap_batched(
            costs, context=ctx_t, instance_ids=inst, row_ids=rows, col_ids=cols, **KW
        )
