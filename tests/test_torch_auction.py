"""Differential tests: the port's torch auction against the JAX auction.

Same integer-valued benefits (numpy, fixed seed) through both packages,
the port on ``device="cpu"``.  Assignments, prices (f32), iteration counts
and convergence flags must agree bit for bit — the port writes out the
vmapped ``while_loop`` with per-instance freezing, so any drift in a phase
boundary shows here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.matching import auction as jx
from repro_torch.core.matching import auction as tx


def _int_benefits(rng, b, n, m, lo=-20, hi=20):
    return rng.integers(lo, hi, size=(b, n, m)).astype(np.float64)


def _assert_same(res_j, res_t):
    np.testing.assert_array_equal(np.asarray(res_j.col_of), res_t.col_of.numpy())
    np.testing.assert_array_equal(np.asarray(res_j.row_of), res_t.row_of.numpy())
    pj = np.asarray(res_j.prices, np.float32)
    pt = res_t.prices.numpy()
    assert pj.dtype == pt.dtype == np.float32
    np.testing.assert_array_equal(pj.view(np.uint32), pt.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(res_j.iters), res_t.iters.numpy())
    np.testing.assert_array_equal(np.asarray(res_j.converged), res_t.converged.numpy())


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_auction_lap_single_matches_jax(use_kernel):
    rng = np.random.default_rng(0)
    for n in (3, 6):
        ben = _int_benefits(rng, 1, n, n)[0]
        res_j = jx.auction_lap(jnp.asarray(ben, jnp.float32), use_kernel=use_kernel)
        res_t = tx.auction_lap(_t(ben), use_kernel=use_kernel)
        _assert_same(res_j, res_t)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_auction_lap_batched_cold_and_warm(use_kernel):
    rng = np.random.default_rng(1)
    # widely different spans: instances finish their epsilon schedules at
    # different rounds, so the batch loop must freeze each one exactly
    ben = _int_benefits(rng, 5, 5, 5)
    ben[1] *= 40.0
    ben[3] = np.round(ben[3] / 10.0)
    res_j = jx.auction_lap_batched(jnp.asarray(ben, jnp.float32), use_kernel=use_kernel)
    res_t = tx.auction_lap_batched(_t(ben), use_kernel=use_kernel)
    _assert_same(res_j, res_t)
    iters = res_t.iters.numpy()
    assert len(set(iters.tolist())) > 1, "instances should converge at different rounds"

    # warm start: last solve's prices on a perturbed instance, mixed flags
    ben2 = ben + rng.integers(-2, 3, size=ben.shape)
    init = np.array(res_j.prices, np.float32)
    warm = np.array([True, False, True, True, False])
    res_j2 = jx.auction_lap_batched(
        jnp.asarray(ben2, jnp.float32),
        use_kernel=use_kernel,
        init_prices=jnp.asarray(init),
        warm=jnp.asarray(warm),
    )
    res_t2 = tx.auction_lap_batched(
        _t(ben2),
        use_kernel=use_kernel,
        init_prices=torch.from_numpy(init),
        warm=torch.from_numpy(warm),
    )
    _assert_same(res_j2, res_t2)


def test_auction_lap_batched_eps_min_and_max_iters():
    rng = np.random.default_rng(2)
    ben = _int_benefits(rng, 4, 6, 6, -50, 50)
    for eps_min, max_iters in ((0.01, 20_000), (None, 7)):
        res_j = jx.auction_lap_batched(
            jnp.asarray(ben, jnp.float32), eps_min=eps_min, max_iters=max_iters,
            use_kernel=False,
        )
        res_t = tx.auction_lap_batched(
            _t(ben), eps_min=eps_min, max_iters=max_iters, use_kernel=False
        )
        _assert_same(res_j, res_t)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_auction_lap_rect_batched_cold_and_warm(use_kernel):
    rng = np.random.default_rng(3)
    ben = _int_benefits(rng, 4, 3, 7)
    ben[2] *= 25.0
    res_j = jx.auction_lap_rect_batched(jnp.asarray(ben, jnp.float32), use_kernel=use_kernel)
    res_t = tx.auction_lap_rect_batched(_t(ben), use_kernel=use_kernel)
    _assert_same(res_j, res_t)
    init = np.array(res_j.prices, np.float32)
    ben2 = ben + rng.integers(-3, 4, size=ben.shape)
    res_j2 = jx.auction_lap_rect_batched(
        jnp.asarray(ben2, jnp.float32), use_kernel=use_kernel, init_prices=jnp.asarray(init)
    )
    res_t2 = tx.auction_lap_rect_batched(
        _t(ben2), use_kernel=use_kernel, init_prices=torch.from_numpy(init)
    )
    _assert_same(res_j2, res_t2)


def test_single_column_second_value_differs_between_bid_paths():
    """JAX fact pinned on purpose: on a 1-column instance the kernel's
    "no second column" value is -1e30 and the plain top-2's is -1e18, so
    the first bid's price differs between the two bid paths — in JAX and,
    identically, in the port."""
    ben = np.array([[[3.0]]])
    prices = {}
    for use_kernel in (False, True):
        res_j = jx.auction_lap_rect_batched(jnp.asarray(ben, jnp.float32), use_kernel=use_kernel)
        res_t = tx.auction_lap_rect_batched(_t(ben), use_kernel=use_kernel)
        _assert_same(res_j, res_t)
        prices[use_kernel] = float(res_t.prices[0, 0])
    assert prices[False] != prices[True]


def test_masked_benefits_and_assignment_match_jax():
    rng = np.random.default_rng(4)
    cost = rng.integers(0, 9, size=(3, 4, 6)).astype(np.float64)
    cost[0, 1, 2] = np.inf
    rm = np.ones((3, 4), bool)
    rm[1, 3] = False
    cm = np.ones((3, 6), bool)
    cm[2, 0] = False
    for maximize in (False, True):
        c = np.where(np.isinf(cost), -np.inf, cost) if maximize else cost
        np.testing.assert_array_equal(
            jx.masked_square_benefit(c, maximize, rm, cm),
            tx.masked_square_benefit(c, maximize, rm, cm),
        )
        np.testing.assert_array_equal(
            jx.masked_rect_benefit(c, maximize, rm, cm),
            tx.masked_rect_benefit(c, maximize, rm, cm),
        )
    rj = jx.auction_assignment(cost[0], row_mask=rm[0], use_kernel=False)
    rt = tx.auction_assignment(cost[0], row_mask=rm[0], use_kernel=False, device="cpu")
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(a, b)


def test_loop_checks_host_flag_every_few_rounds():
    before = tx.loop_syncs.count
    ben = _t(_int_benefits(np.random.default_rng(5), 2, 4, 4))
    res = tx.auction_lap_batched(ben, use_kernel=False)
    syncs = tx.loop_syncs.count - before
    rounds = int(res.iters.max())
    assert syncs == -(-rounds // tx.SYNC_EVERY) + 1


def test_eps_schedule_matches_xla_multiply():
    """XLA compiles the phase step ``eps / 5.0`` to ``eps * 0.2f``; a true
    f32 division differs by one ulp for spans like 13 and 21 and shows in
    the final prices (first diverging input: span 13, instance 50 of this
    batch).  The port multiplies, and agrees bit for bit."""
    rng = np.random.default_rng(0)
    for span in (9, 13, 18, 21):
        ben = rng.integers(0, span, size=(64, 4, 4)).astype(np.float64)
        ben[:, 0, 0] = span
        res_j = jx.auction_lap_batched(jnp.asarray(ben, jnp.float32), use_kernel=False)
        res_t = tx.auction_lap_batched(_t(ben), use_kernel=False)
        _assert_same(res_j, res_t)
