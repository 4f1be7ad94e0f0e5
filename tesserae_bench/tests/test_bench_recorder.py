"""The recorder keeps copies, so a program that reuses its buffers or
keeps them on the device is judged on what each round returned; where an
internal it watches is gone, the round is judged by its plan."""

import numpy as np
import pytest

from tesserae_bench import harness

from conftest import run_tiny
from test_bench_faults import _half_fanout, _unchanged


def test_a_reused_k5_buffer_is_judged_round_by_round(monkeypatch, tmp_path):
    import repro_torch.core.migration as migration

    orig = migration._gpu_pair_costs
    buf = {}

    def reused(*a, **k):
        out = orig(*a, **k)
        b = buf.setdefault(out.shape, np.empty_like(out))
        b[...] = out  # the same host buffer, overwritten every round
        return b

    monkeypatch.setattr(migration, "_gpu_pair_costs", reused)
    out = run_tiny("paper256-backlog", tmp_path, nodes=8, seconds=1.0)
    assert out["correct"], out["compared"]
    assert out["compared"]["k5_cells_off"]["value"] == 0
    ks = [r["k5"] for r in out["rounds"]]
    assert len({id(k) for k in ks}) == len(ks)
    assert any(not np.array_equal(ks[0], k) for k in ks[1:])


def _gone(monkeypatch):
    watched = tuple(
        (mod, f"{attr}_gone", what) if what in ("k5", "pairs_col_of") else (mod, attr, what)
        for mod, attr, what in harness.Recorder.WATCHED
    )
    monkeypatch.setattr(harness.Recorder, "WATCHED", watched)


def test_missing_internals_leave_the_plan_to_judge(monkeypatch, tmp_path):
    _gone(monkeypatch)
    out = run_tiny("paper256-backlog", tmp_path, nodes=8, seconds=1.0)
    assert out["correct"], out["compared"]
    assert "k5_cells_off" not in out["compared"]
    assert out["compared"]["fanout_pairs_off"]["value"] == 0
    assert len(out["window"]["not_watched"]) == 2
    assert all(r["k5"] is None and r["pairs_col_of"] is None for r in out["rounds"])


@pytest.mark.parametrize("fault", [_unchanged, _half_fanout])
def test_judged_by_the_plan_a_broken_round_is_not_correct(fault, monkeypatch, tmp_path):
    _gone(monkeypatch)
    fault(monkeypatch)
    out = run_tiny("paper256-backlog", tmp_path, nodes=8, seconds=1.0)
    assert not out["correct"], out["compared"]


def test_without_plan_migration_the_run_gives_no_result(monkeypatch, tmp_path):
    watched = (("repro_torch.core.scheduler", "plan_migration_gone", "prev, logical"),)
    monkeypatch.setattr(harness.Recorder, "WATCHED", watched + harness.Recorder.WATCHED[1:])
    with pytest.raises(harness.BenchError, match="plan_migration"):
        run_tiny("paper256-backlog", tmp_path, nodes=8, seconds=1.0)
