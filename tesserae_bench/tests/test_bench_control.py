"""The control (``control.py``) comes out not correct, at a size a test
run holds; on the card, ``readings.py`` reads it at the cells' sizes."""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from tesserae_bench import control, harness
from tesserae_bench.reference import tesserae_round as ref

from conftest import run_tiny


def test_coarse_auction_is_a_permutation_within_n_eps():
    rng = np.random.default_rng(3)
    c = rng.integers(0, 40, size=(300, 5, 5)).astype(float)
    col = control.coarse_auction(c, eps=1.0)
    cost, valid = ref.assignment_costs(c, col)
    best = np.array([x[linear_sum_assignment(x)].sum() for x in c])
    assert valid.all() and (cost - best <= 5.0 + 1e-9).all()
    assert (cost > best).any()  # eps = 1 on integer costs is not exact


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_control_is_not_correct(cell, tmp_path):
    out = run_tiny(cell, tmp_path, nodes=8, seconds=2.0)
    assert out["correct"]
    _, config, mix = harness.resolve(harness.load_manifest(), cell)
    table = ref.Jobs(out["jobs"])
    compared, bad = harness.check(
        out["rounds"], out["jobs"], config, dict(mix, reference_rounds=len(out["rounds"])), 7,
        judge=lambda r: control.relabel(r, table, config["cluster"]["gpus_per_node"]),
    )
    assert bad > 0
    assert compared["relabel_gap"]["value"] > 0 or compared["fanout_pairs_off"]["value"] > 0
    assert compared["infeasible_rounds"]["value"] == 0


def test_first_phase_auction_is_a_matching_within_s_eps():
    rng = np.random.default_rng(5)
    for shape in ((40, 130), (130, 40)):
        w = np.round(rng.uniform(0, 2, size=shape), 2) * (rng.random(shape) < 0.6)
        col = control.first_phase_auction(w, 0.5)
        rows = np.flatnonzero(col >= 0)
        assert rows.size == min(shape) and np.unique(col[rows]).size == rows.size
        r, c = linear_sum_assignment(w, maximize=True)
        gap = w[r, c].sum() - w[rows, col[rows]].sum()
        assert -1e-9 <= gap <= min(shape) * 0.5


def test_the_packing_fault_breaks_the_stated_bound():
    """A packing round at the paper cell's shape: 170 placed jobs, which
    hold the larger gangs (a quarter of each size), by 2000 pending ones in
    the mix's gang shares.  The first-phase auction lies past S / (S + 1)
    of the max-weight matching; the exact matching does not."""
    from tesserae_bench import traffic, tput

    rng = np.random.default_rng(0)
    models = sorted(tput.MODELS)
    gangs = np.concatenate([rng.choice([1, 2, 4, 8], size=170),
                            rng.choice([1, 2, 4, 8], p=[0.6, 0.3, 0.09, 0.01], size=2000)])
    jobs = [traffic.Job(j, models[rng.integers(len(models))], int(g), 0.0, 600.0, 32, True)
            for j, g in enumerate(gangs)]
    table = ref.Jobs(jobs)
    rec = dict(placed=np.arange(170), pending=np.arange(170, 2170), matches={})
    w, row, col = ref.packing_weights(rec, table)
    r, c = linear_sum_assignment(w, maximize=True)
    exact = dict(rec, matches={170 + int(j): int(i) for i, j in zip(r, c) if w[i, j] > 0})
    assert ref.packing_gap(exact, table) < 1e-9
    assert ref.packing_gap(control.packing(rec, table), table) > 1.0
