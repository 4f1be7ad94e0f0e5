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
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)


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


# --------------------------------------------------------------------------- #
# the plain loop (kernels/lap_auction.py) against JAX, case by case
# --------------------------------------------------------------------------- #
import jax  # noqa: E402

import repro.core.fused as jfu  # noqa: E402
import repro_torch.core.fused as tfu  # noqa: E402
from repro_torch.kernels import lap_auction as tla  # noqa: E402


def _jax_pair_auction(cost, eps_min, p0, c0, warm, max_iters, use_kernel, tb):
    """JAX ``fused._pair_auction`` over a batch, as the fused program
    vmaps it."""
    solve = jax.vmap(lambda c, p, i, w: jfu._pair_auction(
        c, eps_min, p, i, w, max_iters, use_kernel, tb))
    return solve(jnp.asarray(cost, jnp.float32), jnp.asarray(p0, jnp.float32),
                 jnp.asarray(c0, jnp.int32), jnp.asarray(warm))


def _pair_case(case, rng, b=4, n=5):
    """(cost, init prices, init col_of, warm, max_iters) of one start case."""
    hi = 3 if case == "duplicates" else 30
    cost = rng.integers(0, hi, size=(b, n, n)).astype(np.float32)
    p0 = np.zeros((b, n), np.float32)
    c0 = np.full((b, n), -1, np.int64)
    warm = np.zeros(b, bool)
    max_iters = 7 if case == "max_iters" else 20_000
    if case in ("warm", "complete"):
        p0 = rng.integers(0, 6, size=(b, n)).astype(np.float32)
        warm[::2] = True
    if case == "complete":
        c0 = np.stack([rng.permutation(n) for _ in range(b)])
    return cost, p0, c0, warm, max_iters


@pytest.mark.parametrize("case", ["cold", "warm", "complete", "max_iters", "duplicates"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_lap_auction_plain_matches_jax_pair_auction(case, use_kernel):
    """The fused stage's auctions: ``tfu._pair_auction`` runs the whole loop
    in ``lap_auction_plain`` (kernel semantics with ``use_kernel``: the fused
    assembly and ``-1e30``); every output equals JAX's, bit for bit.  A warm
    instance whose start is complete stops at zero rounds; a cold one from
    the same start changes phase first."""
    rng = np.random.default_rng(len(case) + 10 * use_kernel)
    cost, p0, c0, warm, max_iters = _pair_case(case, rng)
    n = cost.shape[-1]
    tb = tfu._tb_scale(n, n) if case != "duplicates" else 0.0
    eps_min = tb / (n + 1) if tb else 1.0 / (n + 1)
    col_j, p_j, it_j, conv_j = _jax_pair_auction(cost, eps_min, p0, c0, warm, max_iters,
                                                 use_kernel, tb)
    col_t, p_t, it_t, conv_t = tfu._pair_auction(
        torch.from_numpy(cost), eps_min, torch.from_numpy(p0), torch.from_numpy(c0),
        torch.from_numpy(warm), max_iters, use_kernel, tb,
    )
    np.testing.assert_array_equal(np.asarray(col_j), col_t.numpy())
    np.testing.assert_array_equal(np.asarray(p_j).view(np.uint32), p_t.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(it_j), it_t.numpy())
    np.testing.assert_array_equal(np.asarray(conv_j), conv_t.numpy())
    if case == "complete":
        assert (it_t.numpy()[warm] == 0).all() and (it_t.numpy()[~warm] > 0).all()
    if case == "max_iters":
        assert (it_t.numpy() <= max_iters).all() and not conv_t.all()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lap_auction_plain_max_iters_cuts_a_phase_like_jax(use_kernel):
    """``max_iters`` stops each instance mid-phase at its own count; the
    frozen state (prices, partial assignment, not converged) equals
    JAX's."""
    ben = _int_benefits(np.random.default_rng(6), 3, 7, 7, -40, 40)
    for max_iters in (1, 2, 9):
        res_j = jx.auction_lap_batched(jnp.asarray(ben, jnp.float32), max_iters=max_iters,
                                       use_kernel=use_kernel)
        res_t = tx.auction_lap_batched(_t(ben), max_iters=max_iters, use_kernel=use_kernel)
        _assert_same(res_j, res_t)
        assert not res_t.converged.any()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lap_auction_plain_rect_max_iters_and_duplicates_like_jax(use_kernel):
    rng = np.random.default_rng(7)
    ben = rng.integers(0, 2, size=(3, 4, 9)).astype(np.float64)  # many equal offers
    for max_iters in (2, 20_000):
        res_j = jx.auction_lap_rect_batched(jnp.asarray(ben, jnp.float32), max_iters=max_iters,
                                            use_kernel=use_kernel)
        res_t = tx.auction_lap_rect_batched(_t(ben), max_iters=max_iters, use_kernel=use_kernel)
        _assert_same(res_j, res_t)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_single_column_square_and_pair_sentinels_like_jax(use_kernel):
    """m = 1 under both sentinels: the square auction (a phase change
    between bids) and the fused pair auction agree with JAX."""
    ben = np.array([[[3.0]], [[-2.0]]])
    res_j = jx.auction_lap_batched(jnp.asarray(ben, jnp.float32), use_kernel=use_kernel)
    res_t = tx.auction_lap_batched(_t(ben), use_kernel=use_kernel)
    _assert_same(res_j, res_t)
    neg = tla.NEG_INF if use_kernel else tx._NEG
    assert (res_t.prices.numpy() > -np.float32(neg) / 2).all()
    cost = ben.astype(np.float32)
    zeros, unassigned, cold = np.zeros((2, 1), np.float32), np.full((2, 1), -1), np.zeros(2, bool)
    want = _jax_pair_auction(cost, 0.5, zeros, unassigned, cold, 20_000, use_kernel, 0.0)
    got = tfu._pair_auction(torch.from_numpy(cost), 0.5, torch.from_numpy(zeros),
                            torch.from_numpy(unassigned), torch.from_numpy(cold), 20_000,
                            use_kernel, 0.0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_use_kernel_on_cpu_runs_the_plain_loop_and_launches_nothing():
    """``use_kernel=True`` on CPU tensors runs the kernel's plain version,
    which reads the host flag as the plain loop does; the launch counter
    does not move (CPU tensors launch nothing)."""
    before, launches = tx.loop_syncs.count, tla.lap_auction.launches
    tx.auction_lap_batched(_t(_int_benefits(np.random.default_rng(8), 2, 4, 4)),
                           use_kernel=True)
    assert tx.loop_syncs.count > before and tla.lap_auction.launches == launches
