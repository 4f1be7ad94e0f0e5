"""The plain reference: its pieces against independent solvers and the
program's own host arithmetic, and the whole check against ``repro_torch``
on a few rounds at a tiny cluster."""

import itertools

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from tesserae_bench import harness, traffic, tput
from tesserae_bench.reference import tesserae_round as ref

from conftest import run_tiny


def test_pair_optima_match_scipy():
    rng = np.random.default_rng(1)
    c = rng.integers(0, 9, size=(200, 4, 4)).astype(float) / 16
    want = np.array([x[linear_sum_assignment(x)].sum() for x in c])
    assert np.array_equal(ref.pair_optima(c, block=37), want)
    col = np.array([linear_sum_assignment(x)[1] for x in c])
    cost, valid = ref.assignment_costs(c, col)
    assert valid.all() and np.array_equal(cost, want)


def test_cost_matrix_matches_the_program_host_formula():
    from repro_torch.core.migration import _weight_lookup, pairwise_migration_cost

    rng = np.random.default_rng(2)
    jobs = [traffic.Job(j, "resnet50", int(g), 0.0, 600.0, 32, True)
            for j, g in enumerate(rng.choice([1, 2, 4, 8], size=40))]
    table = ref.Jobs(jobs)
    su = rng.integers(-1, 40, size=(96, 2))
    sv = rng.integers(-1, 40, size=(80, 2))
    want = pairwise_migration_cost(su, sv, _weight_lookup({j.job_id: j.num_gpus for j in jobs}))
    assert np.array_equal(ref.cost_matrix(su, sv, table.weight, block=7), want)
    assert np.array_equal(ref.row_costs(su[:80], sv, table.weight), np.diag(want[:80]))


def test_frozen_throughput_model_matches_the_program():
    from repro_torch.core.profiler import ThroughputProfile

    prof = ThroughputProfile()
    for a, b in itertools.product(tput.MODELS, repeat=2):
        assert tput.combined_weight(a, b) == prof.combined_weight(a, b)[0]
        assert tput.isolated(a, 4) == prof.isolated(a, 4)


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_reference_agrees_with_the_program_at_a_tiny_cluster(cell, tmp_path):
    out = run_tiny(cell, tmp_path, nodes=4)
    assert out["correct"], out["compared"]
    assert out["attempted"] == out["window"]["rounds"] > 0
    assert out["failed"] == 0
    for name, c in out["compared"].items():
        assert c["value"] <= c["limit"], name
    # a second run finds the warm state the first saved, and gives the same window
    again = run_tiny(cell, tmp_path, nodes=4)
    assert "loaded_state_s" in again["setup"] and "simulated_state_s" in out["setup"]
    n = min(len(out["rounds"]), len(again["rounds"]))
    for a, b in zip(out["rounds"][:n], again["rounds"][:n]):
        assert np.array_equal(a["phys"], b["phys"]) and a["matches"] == b["matches"]
