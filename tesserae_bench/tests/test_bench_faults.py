"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half of the fan-out left out, an
answer altered where it is produced (K5's matrix, one LAP's assignment).
The cells run on one card, so no exchange between chips can be left out."""

import numpy as np
import pytest

from conftest import run_tiny


def _unchanged(monkeypatch):
    import repro_torch.core.scheduler as scheduler

    orig = scheduler.plan_migration

    def f(prev, new_logical, num_gpus_of, *a, **k):
        res = orig(prev, new_logical, num_gpus_of, *a, **k)
        res.physical_plan = prev.copy()  # the relabel hands back last round's plan
        return res

    monkeypatch.setattr(scheduler, "plan_migration", f)


def _half_fanout(monkeypatch):
    import repro_torch.core.migration as migration

    orig = migration.solve_lap_batched

    def f(costs, *a, **k):
        res = orig(costs, *a, **k)
        if k.get("context_key") == "migration_pairs":
            half = res.col_of.shape[0] // 2
            res.col_of[half:] = np.arange(res.col_of.shape[1])[::-1]  # left unsolved
        return res

    monkeypatch.setattr(migration, "solve_lap_batched", f)


def _k5_cell(monkeypatch):
    import repro_torch.core.migration as migration

    orig = migration.migration_cost_matrix

    def f(*a, **k):
        out = orig(*a, **k).clone()
        out[0, 1] += 0.5
        return out

    monkeypatch.setattr(migration, "migration_cost_matrix", f)


def _lap_answer(monkeypatch):
    import repro_torch.core.matching.auction as auction

    orig = auction.lap_auction

    def f(*a, **k):
        col_of, prices, iters, eps = orig(*a, **k)
        if col_of.shape[1] >= 2:
            col_of = col_of.clone()
            col_of[-1, [0, 1]] = col_of[-1, [1, 0]]
        return col_of, prices, iters, eps

    monkeypatch.setattr(auction, "lap_auction", f)


@pytest.mark.parametrize("fault", [_unchanged, _half_fanout, _k5_cell, _lap_answer])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    out = run_tiny("paper256-backlog", tmp_path, nodes=8, seconds=1.0)
    assert not out["correct"], out["compared"]
    assert out["failed"] > 0
