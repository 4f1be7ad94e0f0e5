"""The port on the card: CUDA kernels against their plain versions, and the
Tesserae round and the fused migrate stage on CUDA against the same on the
CPU.

Every test here needs a CUDA device and skips without one (the ``cuda``
fixture decides at run time).  This file imports neither JAX nor the JAX
package, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CPU side of each comparison is held against the JAX package by the
other ``test_torch_*`` files, so equality here closes the chain
card == CPU port == JAX reference.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.policies import TiresiasPolicy
from repro_torch.core.profiler import ThroughputProfile
from repro_torch.core.scheduler import TesseraeScheduler
from repro_torch.core.traces import synthetic_active_jobs
from repro_torch.core.fused import FusedMigrationPlanner, _tb_scale
from repro_torch.core.matching import auction as tauction
from repro_torch.core.placement import place_without_packing
from repro_torch.kernels.lap_bid import (
    lap_bid_batched,
    lap_bid_fused_batched,
    lap_bid_fused_top2_plain,
    lap_bid_top2_plain,
)
from repro_torch.kernels import lap_auction as la
from repro_torch.kernels.lap_auction import lap_auction, launch_plan
from repro_torch.kernels.migration_cost import migration_cost, migration_cost_plain
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain, splits_for


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _bid_inputs(seed, shape, ints=True):
    g = torch.Generator().manual_seed(seed)
    if ints:
        a = torch.randint(-20, 20, shape, generator=g).float()
    else:
        a = torch.randn(shape, generator=g)
    return a, torch.randint(0, 4, (shape[0], shape[2]), generator=g).float()


@pytest.mark.parametrize(
    "shape,ints",
    [((4096, 4, 4), True), ((1, 512, 512), True), ((3, 5, 7), False),
     ((2, 6, 700), True), ((5, 3, 1), True), ((2, 9, 33), False)],
)
def test_lap_bid_kernel_matches_plain(cuda, shape, ints):
    a, p = _bid_inputs(sum(shape), shape, ints)
    a[0, 0, : min(3, shape[2])] = 99.0  # a tie at the row's start
    before = lap_bid_batched.launches
    got = lap_bid_batched(a.to(cuda), p.to(cuda))
    torch.cuda.synchronize()
    assert lap_bid_batched.launches == before + 1
    for w, g in zip(lap_bid_top2_plain(a, p), got):
        assert torch.equal(w, g.cpu())


def test_lap_bid_kernel_ties_across_warp_stride(cuda):
    a = torch.full((1, 4, 700), -5.0)
    a[0, 0, [31, 32]] = 7.0
    a[0, 1, [5, 37, 69]] = 7.0
    a[0, 2, [100, 600]] = 7.0
    a[0, 3, :] = 1.0
    p = torch.zeros(1, 700)
    best_v, best_j, second = lap_bid_batched(a.to(cuda), p.to(cuda))
    assert best_j.cpu().tolist() == [[31, 5, 100, 0]]
    assert torch.equal(second.cpu(), best_v.cpu())


def _fused_inputs(seed, shape, ints=True):
    g = torch.Generator().manual_seed(seed)
    b, n, m = shape
    if ints:
        cost = torch.randint(0, 40, shape, generator=g).float()
    else:
        cost = torch.randn(shape, generator=g) * 3.0
    prices = torch.randint(0, 4, (b, m), generator=g).float()
    tb = torch.where(torch.arange(b) % 2 == 1, _tb_scale(n, m), 0.0).float()
    return cost, prices, tb


@pytest.mark.parametrize(
    "shape,ints",
    [((262144, 4, 4), True), ((1, 512, 512), True), ((3, 5, 7), False),
     ((2, 6, 700), True), ((5, 3, 1), True), ((4, 9, 33), False)],
)
def test_lap_bid_fused_kernel_matches_plain_bitwise(cuda, shape, ints):
    """Non-integer costs with a non-zero ``tb`` catch a contracted fma:
    the kernel must round after the multiply and after each subtraction."""
    cost, prices, tb = _fused_inputs(sum(shape), shape, ints)
    cost[0, 0, : min(3, shape[2])] = -99.0  # a tie at the row's start
    before = lap_bid_fused_batched.launches
    got = lap_bid_fused_batched(cost.to(cuda), prices.to(cuda), tb.to(cuda))
    torch.cuda.synchronize()
    assert lap_bid_fused_batched.launches == before + 1
    for w, g in zip(lap_bid_fused_top2_plain(cost, prices, tb), got):
        g = g.cpu()
        assert w.dtype == g.dtype
        assert torch.equal(w.view(torch.int32), g.view(torch.int32))


def test_lap_bid_fused_kernel_ties_across_warp_stride(cuda):
    cost = torch.full((1, 4, 700), 5.0)
    cost[0, 0, [31, 32]] = -7.0
    cost[0, 1, [5, 37, 69]] = -7.0
    cost[0, 2, [100, 600]] = -7.0
    cost[0, 3, :] = 1.0
    best_v, best_j, second = lap_bid_fused_batched(
        cost.to(cuda), torch.zeros(1, 700, device=cuda), torch.zeros(1, device=cuda)
    )
    assert best_j.cpu().tolist() == [[31, 5, 100, 0]]
    assert torch.equal(second.cpu(), best_v.cpu())


# --------------------------------------------------------------------------- #
# lap_auction: the whole auction on the card against the plain loop
# --------------------------------------------------------------------------- #
def _same_auction(got, want):
    """All five outputs, bit for bit (prices as their int32 bits)."""
    for name, g, w in zip(tauction.AuctionResult._fields, got, want):
        assert g.dtype == w.dtype, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name


def _hold_auction(solve):
    """``solve(use_kernel)`` once on the kernel (one launch), once on the
    plain loop on the same device; the results must be identical."""
    before = lap_auction.launches
    got = solve(True)
    torch.cuda.synchronize()
    assert lap_auction.launches == before + 1
    want = solve(False)
    _same_auction(got, want)
    return got


def _ints(seed, shape, lo=-20, hi=20):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=g).float()


@pytest.mark.parametrize("n", [1, 2, 4, 8, 31, 32, 33, 64, 255, 256, 512])
@pytest.mark.parametrize("neg", [-1e30, -1e18])
def test_lap_auction_square_cold_and_warm(cuda, n, neg):
    b = 1 if n >= 255 else 3
    ben = _ints(n, (b, n, n)).to(cuda)
    ben[0, :, 0] += 7.0  # duplicate benefits down a column
    cold = _hold_auction(lambda uk: tauction._auction_square(
        ben, None, 20_000, uk, None, None, neg=neg))
    assert bool(cold.converged.all())
    ben2 = ben + _ints(n + 1, (b, n, n), -2, 3).to(cuda)
    warm = torch.ones(b, dtype=torch.bool, device=cuda)
    warm[-1] = b == 1
    _hold_auction(lambda uk: tauction._auction_square(
        ben2, None, 20_000, uk, cold.prices, warm, neg=neg))
    # a complete start: zero rounds when warm, a phase change first when cold
    res = _hold_auction(lambda uk: tauction._auction_square(
        ben2, None, 20_000, uk, cold.prices, warm, cold.col_of, neg=neg))
    assert res.iters[warm].eq(0).all()


@pytest.mark.parametrize("shape", [(1, 8, 600), (1, 640, 1320), (4, 3, 40), (5, 3, 7)])
@pytest.mark.parametrize("neg", [-1e30, -1e18])
def test_lap_auction_rect(cuda, shape, neg):
    b, n, m = shape
    ben = _ints(n * m, shape).to(cuda)
    res = _hold_auction(lambda uk: tauction._auction_rect(ben, None, 20_000, uk, None, neg))
    assert bool(res.converged.all())
    ben2 = ben + _ints(n + m, shape, -2, 3).to(cuda)
    _hold_auction(lambda uk: tauction._auction_rect(ben2, None, 20_000, uk, res.prices, neg))


@pytest.mark.parametrize("shape", [(64, 4, 4), (2, 64, 64), (1, 512, 512), (1, 8, 600)])
@pytest.mark.parametrize("max_iters", [0, 1, 7])
def test_lap_auction_max_iters_cuts_mid_phase(cuda, shape, max_iters):
    ben = _ints(sum(shape), shape, -50, 50).to(cuda)
    if shape[1] == shape[2]:
        res = _hold_auction(lambda uk: tauction._auction_square(
            ben, None, max_iters, uk, None, None, neg=-1e30))
    else:
        res = _hold_auction(lambda uk: tauction._auction_rect(
            ben, None, max_iters, uk, None, -1e30))
    assert res.iters.le(max_iters).all() and (max_iters > 0 or not bool(res.converged.any()))


@pytest.mark.parametrize("shape", [(262144, 4, 4), (4096, 8, 8), (3, 5, 5), (2, 64, 64)])
@pytest.mark.parametrize("tb", ["zero", "mixed", "non-integer"])
def test_lap_auction_fused_assembly(cuda, shape, tb):
    """kFused: the kernel assembles ``(tb * (i+1)^2) * (j+1) - cost``;
    non-integer costs with a non-zero ``tb`` catch a contracted fma."""
    b, n, m = shape
    g = torch.Generator().manual_seed(b + n)
    if tb == "non-integer":
        cost = torch.randn(shape, generator=g) * 3.0
    else:
        cost = torch.randint(0, 40, shape, generator=g).float()
    scale = _tb_scale(n, m)
    tbv = torch.where(torch.arange(b) % 2 == 1, scale, 0.0).float()
    if tb == "zero":
        tbv.zero_()
    cost, tbv = cost.to(cuda), tbv.to(cuda)
    span = torch.clamp_min(cost.abs().amax(dim=(1, 2)), 1.0)
    res = _hold_auction(lambda uk: tauction._auction_square(
        cost, 1.0 / (n + 1), 20_000, uk, None, None, tb=tbv, span=span, neg=-1e30))
    if tb != "non-integer":
        assert bool(res.converged.all())


@pytest.mark.parametrize("neg", [-1e30, -1e18])
def test_lap_auction_single_column_sentinels(cuda, neg):
    """m = 1: the only bid's increment is ``best - neg``, so the price
    lands near ``-neg`` on each path (D2)."""
    ben = _ints(1, (4, 1, 1)).to(cuda)
    sq = _hold_auction(lambda uk: tauction._auction_square(
        ben, None, 20_000, uk, None, None, neg=neg))
    rect = _hold_auction(lambda uk: tauction._auction_rect(ben, None, 20_000, uk, None, neg))
    for res in (sq, rect):
        assert bool(res.converged.all()) and (res.prices > -neg / 2).all()


@pytest.mark.parametrize("n", [64, 100, 512])
def test_lap_auction_equal_offers_across_cluster_ctas(cuda, n):
    """Every row the same: in the first round all rows bid the same offer
    for the same column, from every CTA of the cluster; the lowest row
    must win, as the plain loop's argmax over rows gives."""
    assert launch_plan(1, n, n).cluster > 1
    row = _ints(n, (1, 1, n))
    ben = row.expand(2, n, n).contiguous().to(cuda)
    res = _hold_auction(lambda uk: tauction._auction_square(
        ben, None, 3, uk, None, None, neg=-1e30))
    first = tauction._auction_square(ben, None, 1, True, None, None)
    col = int(torch.argmax(row[0, 0]))
    assert first.row_of[0, col].item() == 0 and (first.col_of[0] >= 0).sum().item() == 1
    assert res.iters.eq(3).all()


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 512, 512), (1, 40, 1320)])
@pytest.mark.parametrize("cluster", [1, 2, 4, 16])
@pytest.mark.parametrize("smem_rows", [True, False])
def test_lap_auction_every_cluster_layout(cuda, shape, cluster, smem_rows):
    """The cluster regime at each cluster size, with the rows in shared
    memory or read from L2, whatever the default plan picks: the same bits."""
    b, n, m = shape
    rows = -(-n // cluster)
    smem = la.cluster_smem(m, rows, smem_rows)
    if smem > la.SMEM_BUDGET:
        pytest.skip(f"{rows} rows of {m} columns do not fit one CTA's shared memory")
    plan = la.AuctionPlan("cluster", 0, cluster, rows, la.CLUSTER_THREADS, b * cluster, smem,
                          smem_rows)
    ben = _ints(n + cluster, shape).to(cuda)
    span = torch.clamp_min(ben.abs().amax(dim=(1, 2)), 1.0)
    em = torch.full((b,), 1.0 / (n + 1), device=cuda)
    thr = em * np.float32(1 + 1e-6) if n == m else torch.full((b,), float("inf"), device=cuda)
    eps0 = torch.maximum(span / 4.0, em) if n == m else em
    args = (ben, torch.zeros(b, m, device=cuda), torch.full((b, n), -1, device=cuda), eps0, em,
            thr, 20_000)
    got = la.lap_auction(*args, plan=plan)
    torch.cuda.synchronize()
    want = la.lap_auction_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w)


def _wide_plan(b, n):
    return la.AuctionPlan("wide", 0, 0, n, la.WIDE_THREADS, b, 0, False)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 512, 512), (1, 40, 1320), (4, 3, 40),
                                   (3, 33, 33)])
@pytest.mark.parametrize("max_iters", [0, 1, 7, 20_000])
@pytest.mark.parametrize("tb", [None, "mixed"])
def test_lap_auction_wide_plan_equals_the_plain_loop(cuda, shape, max_iters, tb):
    """The wide regime (one CTA per instance, column state in global
    memory) forced at shapes the other plans also take: every output bit
    for bit, cut mid-phase by ``max_iters`` too, and with the fused
    benefit assembly."""
    b, n, m = shape
    ben = _ints(n + m + max_iters, shape).to(cuda)
    tbv = None
    if tb is not None:
        tbv = torch.where(torch.arange(b, device=cuda) % 2 == 1, _tb_scale(n, m), 0.0).float()
        ben = ben.abs()
    em = (torch.ones(b, device=cuda) if tbv is None else torch.where(tbv > 0, tbv, 1.0)) / (n + 1)
    if n == m:
        thr = em * np.float32(1 + 1e-6)
        eps0 = torch.maximum(torch.clamp_min(ben.abs().amax(dim=(1, 2)), 1.0) / 4.0, em)
    else:
        thr, eps0 = torch.full((b,), float("inf"), device=cuda), em
    args = (ben, torch.zeros(b, m, device=cuda), torch.full((b, n), -1, device=cuda), eps0, em,
            thr, max_iters)
    before = la.lap_auction.launches
    got = la.lap_auction(*args, tb=tbv, neg=-1e30, plan=_wide_plan(b, n))
    torch.cuda.synchronize()
    assert la.lap_auction.launches == before + 1
    want = la.lap_auction_plain(*args, tb=tbv, neg=-1e30)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w)


@pytest.mark.parametrize("shape", [(1, 8, 6000), (1, 64, 6000), (2, 8, 7000)])
def test_lap_auction_past_shared_memory_takes_the_wide_plan(cuda, shape):
    """Wider than any CTA's shared memory holds the column state: the
    default plan is the wide one, bitwise equal to the plain loop, cold and
    warm from the cold prices, and the engine's cost equals scipy's."""
    from repro_torch.core.matching import solve_lap_batched

    b, n, m = shape
    assert launch_plan(*shape).regime == "wide"
    # the rows share a column preference, so they compete for its best columns
    ben = (_ints(m, (b, 1, m), 0, 50) + _ints(n * m, shape, -3, 4)).to(cuda)
    res = _hold_auction(lambda uk: tauction._auction_rect(ben, None, 20_000, uk, None, -1e18))
    assert bool(res.converged.all())
    ben2 = ben + _ints(n + m, shape, -2, 3).to(cuda)
    _hold_auction(lambda uk: tauction._auction_rect(ben2, None, 20_000, uk, res.prices, -1e18))
    costs = -ben.cpu().double().numpy()
    before = lap_auction.launches
    got = solve_lap_batched(costs, backend="auction_kernel", device=cuda)
    assert lap_auction.launches == before + 1 and not got.used_fallback.any()
    want = solve_lap_batched(costs, backend="scipy", device="cpu")
    np.testing.assert_array_equal(got.total_cost, want.total_cost)


def test_lap_auction_regimes_meet_at_the_split(cuda):
    """Both sides of the warp/cluster split (m = 32 | 33), square and
    rectangular, in one batch each."""
    for shape in ((8, 32, 32), (8, 33, 33), (8, 20, 32), (8, 20, 33)):
        assert launch_plan(*shape).regime == ("warp" if shape[2] <= 32 else "cluster")
        ben = _ints(sum(shape), shape).to(cuda)
        if shape[1] == shape[2]:
            _hold_auction(lambda uk: tauction._auction_square(
                ben, None, 20_000, uk, None, None, neg=-1e30))
        else:
            _hold_auction(lambda uk: tauction._auction_rect(ben, None, 20_000, uk, None, -1e30))


@pytest.mark.parametrize("tie_break,shards", [(False, 1), (True, 3)])
def test_fused_planner_on_card_equals_cpu(cuda, tie_break, shards):
    """The fused planner on CUDA (its auctions on lap_auction) against the
    CPU port (plain top-2): the same plans, costs and stats every step."""
    prof = ThroughputProfile()
    cluster = ClusterSpec(8, 4)
    jobs = synthetic_active_jobs(40, seed=5, profile=prof)
    prev, _, _ = place_without_packing(cluster, jobs)
    new, _, _ = place_without_packing(cluster, jobs[3:])
    new2, _, _ = place_without_packing(cluster, jobs[7:])
    g = {j.job_id: j.num_gpus for j in jobs}
    runs = []
    for dev in (cuda, "cpu"):
        planner = FusedMigrationPlanner(shards=shards, device=dev)
        assert planner.use_kernel == (dev == cuda)
        steps = []
        for new_logical in (new, new, new2):
            before = dict(planner.stats)
            res = planner.plan(prev, new_logical, g, tie_break=tie_break)
            steps.append((res.physical_plan.slots.tolist(), res.node_assignment.tolist(),
                          res.matching_cost,
                          {k: planner.stats[k] - before[k] for k in planner.stats}))
        runs.append(steps)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("u,v", [(2048, 2048), (300, 257), (1, 5)])
def test_migration_cost_kernel_bit_identical(cuda, u, v):
    g = torch.Generator().manual_seed(u + v)
    su = torch.randint(-1, 40, (u, 2), generator=g, dtype=torch.int32)
    sv = torch.randint(-1, 40, (v, 2), generator=g, dtype=torch.int32)
    w = torch.tensor([0.5, 0.25, 0.125, 0.0625], dtype=torch.float64)
    wu = torch.where(su < 0, 0.0, w[su.clamp_min(0) % 4])
    wv = torch.where(sv < 0, 0.0, w[sv.clamp_min(0) % 4])
    before = migration_cost.launches
    got = migration_cost(su.to(cuda), sv.to(cuda), wu.to(cuda), wv.to(cuda)).cpu()
    assert migration_cost.launches == before + 1
    want = migration_cost_plain(su, sv, wu, wv)
    assert torch.equal(want.view(torch.int64), got.view(torch.int64))


def _decide_rounds(device, backend):
    prof = ThroughputProfile()
    sched = TesseraeScheduler(
        ClusterSpec(8, 4), TiresiasPolicy(prof), prof, lap_backend=backend, device=device
    )
    jobs = synthetic_active_jobs(40, seed=2, profile=prof)
    d1 = sched.decide(jobs, now=0.0)
    d2 = sched.decide(jobs[::2] + jobs[1::4], now=360.0, prev_plan=d1.plan)
    d3 = sched.decide(jobs[1::2], now=720.0, prev_plan=d2.plan)
    return [d1, d2, d3]


def test_fused_decide_launches_the_fused_kernel(cuda):
    """The fused round's auctions (each pair chunk with the fused benefit
    assembly, then the node match) are launches of ``lap_auction``, which
    read nothing back: the round keeps its one readout."""
    before, syncs = lap_auction.launches, tauction.loop_syncs.count
    prof = ThroughputProfile()
    sched = TesseraeScheduler(
        ClusterSpec(8, 4), TiresiasPolicy(prof), prof, fused_fanout=True, device=cuda
    )
    jobs = synthetic_active_jobs(40, seed=2, profile=prof)
    d1 = sched.decide(jobs, now=0.0)
    d2 = sched.decide(jobs[::2], now=360.0, prev_plan=d1.plan)
    assert lap_auction.launches > before and tauction.loop_syncs.count == syncs
    assert d2.match_stats["fused_readouts"] == 1
    assert d2.migration.algorithm == "node-fused"


@pytest.mark.parametrize("backend", ["auction_kernel", "auction"])
def test_decide_on_card_equals_cpu(cuda, backend):
    before = (lap_auction.launches, migration_cost.launches)
    on_card = _decide_rounds(cuda, backend)
    if backend == "auction_kernel":
        assert lap_auction.launches > before[0]
    assert migration_cost.launches > before[1]
    on_cpu = _decide_rounds("cpu", backend)
    for dg, dc in zip(on_card, on_cpu):
        np.testing.assert_array_equal(dg.plan.slots, dc.plan.slots)
        assert dg.packing.matches == dc.packing.matches
        assert dg.match_stats == dc.match_stats
        if dc.migration is not None:
            assert dg.migration.matching_cost == dc.migration.matching_cost


# --------------------------------------------------------------------------- #
# K6 / K7: the attention kernels against their plain versions
# --------------------------------------------------------------------------- #
_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _attn_inputs(seed, b, s, h, kv, d, dtype):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g).to(dtype)
    k = torch.randn((b, s, kv, d), generator=g).to(dtype)
    v = torch.randn((b, s, kv, d), generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,causal", [(1, True), (127, True), (200, False), (640, True), (333, False)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, d, s, causal):
    q, k, v = _attn_inputs(s + d, 2, s, 4, 2, d, dtype)
    before = flash_attention.launches
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gqa_routing_equals_repeated_kv(cuda, dtype):
    """Query head h reads KV head h // G inside the kernel; the result equals
    the reference's path, which repeats the KV heads and runs (BH, S, D)."""
    b, s, h, kv, d = 2, 300, 8, 2, 128
    q, k, v = (t.to(cuda) for t in _attn_inputs(7, b, s, h, kv, d, dtype))
    got = flash_attention(q, k, v, causal=True)
    kr = torch.repeat_interleave(k, h // kv, dim=2)
    vr = torch.repeat_interleave(v, h // kv, dim=2)
    rep = ops.flash_attention(q.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, rep.transpose(1, 2), rtol=_TOL[dtype], atol=_TOL[dtype])
    bh = ops.flash_attention(
        q.transpose(1, 2).reshape(b * h, s, d), kr.transpose(1, 2).reshape(b * h, s, d),
        vr.transpose(1, 2).reshape(b * h, s, d),
    )
    torch.testing.assert_close(bh.reshape(b, h, s, d), rep, rtol=0, atol=0)


def test_sdpa_defaults_to_the_flash_kernel_on_cuda(cuda, monkeypatch):
    from repro_torch.models.attention import sdpa

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    q, k, v = (t.to(cuda) for t in _attn_inputs(3, 1, 96, 4, 2, 64, torch.bfloat16))
    before = flash_attention.launches
    flash = sdpa(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    monkeypatch.setenv("REPRO_USE_FLASH", "0")
    einsum = sdpa(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(flash.float(), einsum.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("d", [80, 192])
def test_sdpa_at_a_head_dim_without_a_kernel_runs_the_einsum_path(cuda, monkeypatch, d):
    """Unset, a causal sdpa at a head dim K6 has no instance for runs the
    einsum path on the card and matches the CPU's (2e-5, f32);
    ``REPRO_USE_FLASH=1`` asks for the kernel there and raises."""
    from repro_torch.models.attention import sdpa

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    q, k, v = _attn_inputs(4, 1, 96, 4, 2, d, torch.float32)
    want = sdpa(q, k, v, causal=True)
    before = flash_attention.launches
    got = sdpa(q.to(cuda), k.to(cuda), v.to(cuda), causal=True)
    assert flash_attention.launches == before
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    with pytest.raises(ValueError, match=f"head dim {d}"):
        sdpa(q.to(cuda), k.to(cuda), v.to(cuda), causal=True)


def _decode_inputs(seed, b, h, kv, s, d, dtype):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, h, d), generator=g).to(dtype)
    k = torch.randn((b, s, kv, d), generator=g).to(dtype)
    v = torch.randn((b, s, kv, d), generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,kv,s,d,valid",
    [(2, 8, 2, 512, 64, 512), (2, 8, 2, 512, 64, 7), (1, 12, 2, 1000, 128, 999),
     (3, 8, 8, 300, 128, 300), (2, 32, 8, 4096, 128, 63), (1, 4, 4, 128, 64, 0)],
)
def test_flash_decode_kernel_matches_plain(cuda, dtype, b, h, kv, s, d, valid):
    q, k, v = _decode_inputs(s + valid, b, h, kv, s, d, dtype)
    before = flash_decode.launches
    got = flash_decode(q.to(cuda), k.to(cuda), v.to(cuda), valid)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    want = flash_decode_plain(q, k, v, valid)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol)
    if valid == 0:
        assert not got.any()


def test_flash_decode_valid_len_across_a_split_boundary(cuda):
    """valid_len at, just below and just past the end of a split's tiles, and
    read on the device from a 0-d tensor; slots past it are ignored."""
    b, h, kv, s, d = 1, 8, 2, 8192, 128
    nsplit, per = splits_for(b * kv, s)
    assert nsplit > 1
    edge = per * 64
    q, k, v = _decode_inputs(11, b, h, kv, s, d, torch.float32)
    qc, kc, vc = q.to(cuda), k.to(cuda), v.to(cuda)
    for valid in (edge - 1, edge, edge + 1, s):
        got = flash_decode(qc, kc, vc, torch.tensor(valid, device=cuda))
        torch.testing.assert_close(got.cpu(), flash_decode_plain(q, k, v, valid), rtol=2e-5, atol=2e-5)
        k2, v2 = kc.clone(), vc.clone()
        k2[:, valid:] = 1e4
        v2[:, valid:] = -1e4
        torch.testing.assert_close(flash_decode(qc, k2, v2, valid), got, rtol=0, atol=0)


def test_flash_decode_rejects_per_batch_valid_len(cuda):
    q, k, v = (t.to(cuda) for t in _decode_inputs(0, 2, 4, 2, 64, 64, torch.float32))
    with pytest.raises(ValueError, match="scalar"):
        flash_decode(q, k, v, torch.tensor([4, 4], device=cuda))
    with pytest.raises(ValueError, match="scalar"):
        ops.flash_decode(q, k, v, torch.tensor([4, 4], device=cuda))


def test_flash_kernels_reject_a_head_dim_without_an_instance(cuda):
    q, k, v = (t.to(cuda) for t in _attn_inputs(0, 1, 16, 2, 2, 32, torch.float32))
    with pytest.raises(ValueError, match="head dim 32"):
        flash_attention(q, k, v)
    q, k, v = (t.to(cuda) for t in _decode_inputs(0, 1, 2, 2, 16, 32, torch.float32))
    with pytest.raises(ValueError, match="head dim 32"):
        flash_decode(q, k, v, 16)


# --------------------------------------------------------------------------- #
# K6 / K7: the Hopper designs' tile edges (bf16 on wgmma + TMA for K6, the
# bf16 cp.async ring for K7), compared on the card with the plain versions
# --------------------------------------------------------------------------- #
def _cuda_attn(seed, b, s, h, kv, d, dtype, device):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g, device=device).to(dtype)
    k = torch.randn((b, s, kv, d), generator=g, device=device).to(dtype)
    v = torch.randn((b, s, kv, d), generator=g, device=device).to(dtype)
    return q, k, v


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 255, 256, 257, 1000, 4113])
def test_flash_attention_bf16_tile_edges(cuda, s, causal, d, g):
    """S on both sides of the 128-row query and key tiles (TMA zero-fills
    past S; those keys are masked from their indices), D over one or two
    64-wide swizzled panels, G query heads per KV head at B = 2."""
    q, k, v = _cuda_attn(s * 7 + d + g, 2, s, 2 * g, 2, d, torch.bfloat16, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [257, 1000])
def test_flash_attention_bf16_reads_fused_qkv_views(cuda, s, d):
    """q, k and v as strided views of one (B, S, H + 2 KV, D) projection:
    the tensor maps walk the fused rows, no copy is made."""
    b, h, kv = 2, 8, 2
    g = torch.Generator(device=cuda).manual_seed(s + d)
    x = torch.randn((b, s, h + 2 * kv, d), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = x[:, :, :h], x[:, :, h:h + kv], x[:, :, h + kv:]
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_rescale_when_the_max_is_in_the_last_tile(cuda, causal):
    """Query rows that find their maximum only in the last key tile they
    see (the second of two): the running max jumps there, and the
    accumulator of the first tile must be rescaled by it.  Non-causal: rows
    of the first query tile against keys 128 later; causal: rows of the
    second query tile against their own (diagonal) key."""
    s, d = 256, 128
    q, k, v = _cuda_attn(5, 1, s, 2, 1, d, torch.bfloat16, cuda)
    rows = torch.arange(120, 128, device=cuda) + (128 if causal else 0)
    keys = rows if causal else rows + 128
    k[0, keys, 0] = (q[0, rows, 0].float() * 0.5).to(torch.bfloat16)
    got = flash_attention(q, k, v, causal)
    want = flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)
    scores = q[0, rows, 0].float() @ k[0, :, 0].float().T
    if causal:
        scores = scores.masked_fill(torch.arange(s, device=cuda)[None, :] > rows[:, None], -1e30)
    assert bool((scores.argmax(-1) == keys).all())  # the maximum does sit there


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,causal", [(65, True), (257, False), (1000, True)])
def test_flash_attention_f32_keeps_the_cuda_core_instance(cuda, s, causal, d):
    """f32 inputs stay on the f32 CUDA-core instance, within 2e-5 of the
    plain version (tensor cores in TF32 would not be)."""
    from repro_torch.kernels.flash_attention import launch_plan

    q, k, v = _cuda_attn(s + d, 2, s, 4, 2, d, torch.float32, cuda)
    assert launch_plan(q.shape, 2, q.dtype)["instance"] == "cc_f32"
    got = flash_attention(q, k, v, causal)
    want = flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


_RING = {64: 4 * 64, 128: 3 * 64}  # slots in a full ring of the bf16 kernel


@pytest.mark.parametrize("single_split", [True, False])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("valid", ["0", "1", "63", "64", "65", "ring+1", "2ring+1", "S"])
def test_flash_decode_bf16_ring_edges(cuda, valid, d, g, single_split):
    """valid_len at 0, one slot, both sides of a 64-slot tile, one and two
    ring wraps past a stage boundary and the whole cache; as the wrapper
    splits it and with B = 1 in one split that walks every tile."""
    from repro_torch.kernels import flash_decode as fd

    s, kv = 1024, 2
    n = {"0": 0, "1": 1, "63": 63, "64": 64, "65": 65, "ring+1": _RING[d] + 1,
         "2ring+1": 2 * _RING[d] + 1, "S": s}[valid]
    b = 1 if single_split else 2
    gen = torch.Generator(device=cuda).manual_seed(n + d + g)
    q = torch.randn((b, g * kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    assert fd.ring_stages(d) * 64 == _RING[d]
    if single_split:
        plan = dict(plan, splits=1, tiles_per_split=s // 64, part_floats=b * kv * g * (d + 2))
    before = fd.flash_decode.launches
    got = fd._launch(q, k, v, torch.tensor(n, device=cuda), plan)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    want = flash_decode_plain(q, k, v, n)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)
    if n == 0:
        assert not got.any()
    k2, v2 = k.clone(), v.clone()  # slots at or past valid_len are never read
    k2[:, n:] = 1e4
    v2[:, n:] = -1e4
    torch.testing.assert_close(fd._launch(q, k2, v2, n, plan), got, rtol=0, atol=0)
