"""Differential tests: the port's matching engine against the JAX engine.

A short seeded multi-round replay (instances mutate, churn, return from
the departed LRU and permute) goes through ``solve_lap_batched`` of both
packages, each with its own ``MatchContext`` (the port's on the CPU).
Every result field and every context stat must agree exactly, for every
backend and both ``tie_break`` settings.  Also: the rectangular price
certificate, targeted invalidation, and the npz state files, which load
in either package.
"""

import numpy as np
import pytest
import torch

from repro.core.matching import engine as jx
from repro_torch.core.matching import engine as tx
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

BACKENDS = ["scipy", "numpy", "smallperm", "auction", "auction_kernel", "auto"]


def _square_replay(seed, rounds=4, b=5, k=4):
    """Rounds of (costs (B,k,k), instance_ids, row_ids, col_ids)."""
    rng = np.random.default_rng(seed)
    pool = {i: (rng.integers(0, 7, size=(k, k)).astype(float), i * 100) for i in range(b + 2)}
    live = list(range(b))
    out = []
    for r in range(rounds):
        if r == 1:
            pool[live[0]][0][1] = rng.integers(0, 7, size=k)  # one row changes
        if r == 2:
            live = live[1:] + [b]  # instance 0 departs, b arrives
            pool[live[1]][0][:, 2] += 1.0  # a column's cells change
        if r == 3:
            live = [0] + live[::-1]  # instance 0 returns; order permutes
        costs = np.stack([pool[i][0] for i in live])
        inst = np.array(live, np.int64)
        rows = np.stack([pool[i][1] + np.arange(k) for i in live])
        cols = np.stack([1000 + pool[i][1] + np.arange(k)[::-1] for i in live])
        out.append((costs.copy(), inst, rows, cols))
    return out


def _rect_replay(seed, rounds=4):
    """Packing-like rounds: one (n, m) max-weight instance whose jobs churn
    (rows = placed jobs, cols = pending jobs), float weights."""
    rng = np.random.default_rng(seed)
    w = {j: rng.uniform(0.2, 2.0, size=12) for j in range(8)}
    placed, pending = [0, 1, 2], [3, 4, 5, 6, 7]
    out = []
    for r in range(rounds):
        if r == 2:
            placed, pending = [0, 2, 3], [1, 4, 5, 6, 7]
        if r == 3:
            pending = pending[::-1] + [8]
            w[8] = rng.uniform(0.2, 2.0, size=12)
        costs = np.array([[w[p][q % 12] for q in pending] for p in placed])
        costs[0, 1] = 0.0  # a missing edge
        out.append(
            (costs[None], np.zeros(1, np.int64), np.array(placed), np.array(pending))
        )
    return out


def _assert_results_equal(rj, rt):
    np.testing.assert_array_equal(rj.col_of, rt.col_of)
    np.testing.assert_array_equal(rj.total_cost, rt.total_cost)
    np.testing.assert_array_equal(rj.converged, rt.converged)
    np.testing.assert_array_equal(rj.used_fallback, rt.used_fallback)
    np.testing.assert_array_equal(rj.bid_iters, rt.bid_iters)
    np.testing.assert_array_equal(rj.warm, rt.warm)
    assert rj.backend == rt.backend and rj.embedding == rt.embedding


def _solve_both(ctx_j, ctx_t, costs, inst, rows, cols, **kw):
    args = dict(instance_ids=inst, row_ids=rows, col_ids=cols, **kw)
    before_j, before_t = dict(ctx_j.stats), dict(ctx_t.stats)
    rj = jx.solve_lap_batched(costs, context=ctx_j, **args)
    rt = tx.solve_lap_batched(costs, context=ctx_t, **args)
    _assert_results_equal(rj, rt)
    delta_j = {k: v - before_j[k] for k, v in ctx_j.stats.items()}
    delta_t = {k: v - before_t[k] for k, v in ctx_t.stats.items()}
    assert delta_j == delta_t
    return rj, rt


@pytest.mark.parametrize("tie_break", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_square_replay_matches_jax(backend, tie_break):
    ctx_j, ctx_t = jx.MatchContext(), tx.MatchContext(device="cpu")
    for costs, inst, rows, cols in _square_replay(seed=11):
        _solve_both(
            ctx_j, ctx_t, costs, inst, rows, cols,
            backend=backend, tie_break=tie_break, context_key="pairs",
        )
    assert ctx_t.stats["solves"] == 4
    if backend in ("auction", "auction_kernel"):
        assert ctx_t.stats["bid_iters"] > 0 and ctx_t.stats["memo_instances"] > 0


@pytest.mark.parametrize("tie_break", [False, True])
@pytest.mark.parametrize("backend", ["scipy", "auction", "auction_kernel"])
def test_rect_replay_matches_jax(backend, tie_break):
    ctx_j, ctx_t = jx.MatchContext(), tx.MatchContext(device="cpu")
    for costs, inst, rows, cols in _rect_replay(seed=12):
        _solve_both(
            ctx_j, ctx_t, costs, inst, rows, cols,
            backend=backend, tie_break=tie_break, maximize=True, context_key="packing",
        )
        # transposed orientation (n > m) through the same family
        _solve_both(
            ctx_j, ctx_t, np.swapaxes(costs, 1, 2), inst, cols, rows,
            backend=backend, tie_break=tie_break, maximize=True, context_key="packing_t",
        )


def test_rect_certificate_fires_identically():
    """Stale high prices on unassigned columns: both engines' certificates
    must flag the same instances and re-solve them the same way."""
    rng = np.random.default_rng(9)
    costs = rng.uniform(0, 10, (4, 4, 16))
    ctx_j, ctx_t = jx.MatchContext(), tx.MatchContext(device="cpu")
    _solve_both(ctx_j, ctx_t, costs, None, None, None, backend="auction", context_key="c")
    ej = next(iter(ctx_j._entries.values()))
    et = next(iter(ctx_t._entries.values()))
    assigned = np.zeros((4, 16), bool)
    np.put_along_axis(assigned, ej.col_solve, ej.col_solve >= 0, axis=1)
    poisoned = np.where(assigned, np.asarray(ej.prices), 1e6).astype(np.float32)
    ej.prices = poisoned
    et.prices = torch.from_numpy(poisoned.copy())
    costs2 = costs.copy()
    for i in range(4):
        costs2[i, i % 4] = rng.uniform(0, 10, 16)
    _solve_both(ctx_j, ctx_t, costs2, None, None, None, backend="auction", context_key="c")
    assert ctx_t.stats["cert_violations"] >= 1


def test_rect_violation_verdicts_match_jax():
    rng = np.random.default_rng(13)
    flagged = []
    for r, c in ((3, 40), (1, 6)):
        b = 200
        prices = rng.integers(0, 8, size=(b, c)).astype(np.float32)
        prices += rng.choice([0.0, 1e-7, 0.5, 3e-7], size=(b, c)).astype(np.float32)
        col_solve = np.stack([rng.permutation(c)[:r] for _ in range(b)])
        col_solve[0, 0] = -1
        want = jx._rect_bound_violation(prices, col_solve)
        got = tx._rect_bound_violation(torch.from_numpy(prices), col_solve)
        np.testing.assert_array_equal(want, got)
        flagged += want.tolist()
    assert any(flagged) and not all(flagged)


def test_positions_and_prologue_match_host_rule():
    rng = np.random.default_rng(14)
    old = np.stack([rng.permutation(50)[:8] for _ in range(3)]).astype(np.int64)
    new = np.stack([rng.permutation(50)[:6] for _ in range(3)]).astype(np.int64)
    new[:, 0] = old[:, 3]
    want = jx._positions_in(new, old)
    got = tx._positions_in_dev(torch.from_numpy(new), torch.from_numpy(old)).numpy()
    np.testing.assert_array_equal(want, got)


def test_invalidate_instances_matches_jax():
    ctx_j, ctx_t = jx.MatchContext(), tx.MatchContext(device="cpu")
    rounds = _square_replay(seed=15)
    for costs, inst, rows, cols in rounds[:2]:
        _solve_both(ctx_j, ctx_t, costs, inst, rows, cols, backend="auction", context_key="p")
    assert ctx_j.invalidate_instances([inst[1], 999]) == ctx_t.invalidate_instances(
        [inst[1], 999]
    )
    costs, inst, rows, cols = rounds[1]
    _solve_both(ctx_j, ctx_t, costs, inst, rows, cols, backend="auction", context_key="p")


def _npz_state_equal(path_a, path_b):
    with np.load(path_a) as za, np.load(path_b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for name in za.files:
            if name == "meta_json":
                continue
            np.testing.assert_array_equal(za[name], zb[name], err_msg=name)
            assert za[name].dtype == zb[name].dtype, name


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_npz_state_loads_across_packages(direction, tmp_path):
    """A context saved by one package loads in the other, and the next
    solve is bit-identical to the saving package's own continuation."""
    rounds = _square_replay(seed=16)
    ctx_j, ctx_t = jx.MatchContext(), tx.MatchContext(device="cpu")
    for costs, inst, rows, cols in rounds[:3]:
        _solve_both(ctx_j, ctx_t, costs, inst, rows, cols, backend="auction", context_key="p")
    pj, pt = tmp_path / "jax.npz", tmp_path / "torch.npz"
    ctx_j.save(str(pj))
    ctx_t.save(str(pt))
    _npz_state_equal(pj, pt)
    if direction == "jax_to_torch":
        ctx_j2, ctx_t2 = ctx_j, tx.MatchContext.load(str(pj), device="cpu")
    else:
        ctx_j2, ctx_t2 = jx.MatchContext.load(str(pt)), ctx_t
    assert ctx_j2.stats == ctx_t2.stats
    costs, inst, rows, cols = rounds[3]
    _solve_both(ctx_j2, ctx_t2, costs, inst, rows, cols, backend="auction", context_key="p")


def test_context_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert tx.MatchContext().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tx.MatchContext()
