"""The port's matching engine against the JAX package's committed records.

``BENCH_matching_warmstart.json`` and ``BENCH_matching_churn.json`` hold
the bid-iteration totals of seeded replays through the JAX engine's
``auction`` backend.  The replays below regenerate the same traces (the
generators of ``benchmarks/matching_microbench.py``, same seeds and
defaults) and run them through the port on the CPU: the totals must be
exactly the recorded ones, and every round must keep scipy's optimum.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.matching import MatchContext, solve_lap_batched

ROOT = Path(__file__).resolve().parents[1]


def _record(name, **match):
    doc = json.loads((ROOT / name).read_text())
    hits = [r for r in doc["records"] if all(r.get(k) == v for k, v in match.items())]
    assert len(hits) == 1, (name, match)
    return hits[0]


def _mutated_trace(rng, base, rounds, churn):
    lo, hi = 0, int(base.max()) + 1
    trace = [base]
    costs = base
    for _ in range(rounds - 1):
        costs = costs.copy()
        n_mut = max(1, int(round(churn * costs.shape[0])))
        for i in rng.choice(costs.shape[0], n_mut, replace=False):
            costs[i, rng.integers(costs.shape[1])] = rng.integers(lo, hi, costs.shape[2])
        trace.append(costs)
    return trace


def _churn_trace(rng, pool, k, rounds, rate):
    costs = rng.integers(0, 16, (pool, k, k)).astype(np.float64)
    ids = np.arange(pool, dtype=np.int64)
    next_id = pool
    trace = [(ids, costs)]
    for _ in range(rounds - 1):
        b = len(ids)
        n_dep = min(b - 1, rng.binomial(b, rate))
        n_arr = rng.binomial(pool, rate)
        keep = rng.permutation(b)[: b - n_dep]
        fresh = rng.integers(0, 16, (n_arr, k, k)).astype(np.float64)
        costs = np.concatenate([costs[keep], fresh])
        ids = np.concatenate([ids[keep], next_id + np.arange(n_arr, dtype=np.int64)])
        next_id += n_arr
        n_mut = max(1, int(round(rate * len(keep) / 2)))
        costs = costs.copy()
        for i in rng.choice(len(keep), min(n_mut, len(keep)), replace=False):
            costs[i, rng.integers(k)] = rng.integers(0, 16, k)
        trace.append((ids, costs))
    return trace


def _warmstart_traces():
    rng = np.random.default_rng(7)
    base = rng.integers(0, 16, (256, 4, 4)).astype(np.float64)
    square = _mutated_trace(rng, base, 24, 0.05)
    rect_base = np.round(rng.uniform(0, 4, (8, 96, 12)), 2)
    rect = _mutated_trace(rng, rect_base, 6, 0.25)
    return {"warmstart_replay": (square, False), "warmstart_rect_replay": (rect, True)}


@pytest.mark.parametrize("bench", ["warmstart_replay", "warmstart_rect_replay"])
@pytest.mark.parametrize("arm", ["cold", "warm"])
def test_warmstart_replay_matches_record(bench, arm):
    trace, maximize = _warmstart_traces()[bench]
    ctx = MatchContext(device="cpu")
    total = 0
    for costs in trace:
        if arm == "cold":
            ctx = MatchContext(device="cpu")
        res = solve_lap_batched(
            costs, maximize=maximize, backend="auction", context=ctx,
            context_key="replay", device="cpu",
        )
        ref = solve_lap_batched(costs, maximize=maximize, backend="scipy")
        s = min(costs.shape[1], costs.shape[2])
        assert res.converged.all()
        assert np.all(np.abs(res.total_cost - ref.total_cost) <= s / (s + 1) + 1e-6)
        total += int(res.bid_iters.sum())
    assert total == _record("BENCH_matching_warmstart.json", bench=bench, arm=arm)["total_bid_iters"]


@pytest.mark.parametrize("rate", [0.05, 0.15, 0.3])
def test_churn_replay_matches_record(rate):
    trace = _churn_trace(np.random.default_rng(13), 64, 4, 30, rate)
    for arm in ("identity", "shape_keyed", "cold"):
        ctx = MatchContext(device="cpu")
        prev_b = None
        total = 0
        for ids, costs in trace:
            if arm == "cold" or (arm == "shape_keyed" and prev_b != costs.shape[0]):
                ctx = MatchContext(device="cpu")
            prev_b = costs.shape[0]
            res = solve_lap_batched(
                costs, backend="auction", context=ctx, context_key="churn",
                instance_ids=ids if arm == "identity" else None,
            )
            ref = solve_lap_batched(costs, backend="scipy")
            assert res.converged.all()
            np.testing.assert_allclose(res.total_cost, ref.total_cost, atol=1e-9)
            total += int(res.bid_iters.sum())
        want = _record("BENCH_matching_churn.json", bench="churn_replay", arm=arm, rate=rate)
        assert total == want["total_bid_iters"], arm
