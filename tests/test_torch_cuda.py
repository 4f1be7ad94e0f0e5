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

import ctypes
import dataclasses

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
from repro_torch.kernels import build
from repro_torch.kernels import lap_bid as lb
from repro_torch.kernels.lap_bid import (
    lap_bid_batched,
    lap_bid_fused_batched,
    lap_bid_fused_top2_plain,
    lap_bid_top2_plain,
)
from repro_torch.kernels import lap_auction as la
from repro_torch.kernels.lap_auction import lap_auction, launch_plan
from repro_torch.kernels import migration_cost as mc
from repro_torch.kernels.migration_cost import migration_cost, migration_cost_plain
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from torch_rect_replay import packing_replay, traced_packing


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


def _poison_next_blocks(device, *numels):
    """Hand the caching allocator's next blocks of these f32 sizes back full
    of NaN bits, so an output cell a kernel never writes cannot pass for a
    written one."""
    junk = [torch.full((k,), float("nan"), device=device) for k in numels]
    del junk


def _offset_copy(x, offset, device):
    """``x`` on the card as a contiguous view whose base sits ``offset``
    elements past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=device)
    view = flat[offset:offset + x.numel()].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("change", ["grid", "group", "threads"])
def test_lap_bid_entry_refuses_a_geometry_that_misses_rows(cuda, change, fused):
    """The entry points launch the geometry they are given, so they refuse
    one that leaves a row unread (a grid one CTA short), a group that is not
    a power of two and a block that is not whole warps."""
    b, n, m = 3, 100, 8
    geo = lb.launch_geometry(b, n, m)
    geo = dataclasses.replace(geo, **{"grid": dict(grid=geo.grid - 1),
                                      "group": dict(group=3),
                                      "threads": dict(threads=48)}[change])
    a = torch.zeros((b, n, m), device=cuda)
    p = torch.zeros((b, m), device=cuda)
    outs = [torch.empty((b, n), dtype=dt, device=cuda)
            for dt in (torch.float32, torch.int32, torch.float32)]
    operands = (a, p, torch.zeros(b, device=cuda)) if fused else (a, p)
    fn = getattr(build.library("lap_bid"), "lap_bid_fused_batched" if fused else "lap_bid_batched")
    fn.argtypes = ([ctypes.c_void_p] * (len(operands) + 3) + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_uint, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in (*operands, *outs)), b, n, m, geo.group, geo.threads,
             geo.grid, geo.div_mul, geo.div_shr, torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("m", [1, 3, 4, 5, 8, 9, 600, 4097])
def test_lap_bid_kernels_at_ragged_widths_and_offset_bases(cuda, m, offset, ints, fused):
    """Rows whose starts fall anywhere in a 16-byte chunk (ragged m, and a
    matrix and prices whose bases are ``offset`` f32 past a boundary) take
    the scalar head and tail; bit for bit against the plain versions,
    non-integer fused costs included."""
    b, n = 3, 7
    g = torch.Generator().manual_seed(m * 16 + offset * 2 + ints)
    if ints:
        a = torch.randint(-20, 20, (b, n, m), generator=g).float()
        p = torch.randint(0, 4, (b, m), generator=g).float()
    else:
        a = torch.randn((b, n, m), generator=g) * 3.0
        p = torch.randn((b, m), generator=g)
    a[0, 0, : min(5, m)] = a[0, 0].max()  # a tie at the row's start
    tb = torch.where(torch.arange(b) % 2 == 1, _tb_scale(n, m), 0.5).float()
    ac, pc = _offset_copy(a, offset, cuda), _offset_copy(p, (offset + 1) % 4, cuda)
    _poison_next_blocks(cuda, b * n, b * n, b * n)
    if fused:
        got = lap_bid_fused_batched(ac, pc, tb.to(cuda))
        want = lap_bid_fused_top2_plain(a, p, tb)
    else:
        got = lap_bid_batched(ac, pc)
        want = lap_bid_top2_plain(a, p)
    for w, o in zip(want, got):
        assert torch.equal(w.view(torch.int32), o.cpu().view(torch.int32))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_lap_bid_ties_across_the_head_and_chunk_boundaries(cuda, offset, fused):
    """Equal maxima on both sides of the scalar head, of a 16-byte chunk, of
    a lane's stride (32 chunks) and at the row's two ends: the lower column
    wins and the second equals the best."""
    m = 600  # every row starts ``offset`` f32 past a boundary
    head = (4 - offset) % 4  # scalar columns before the row's first 16-byte boundary
    pairs = [(head - 1, head), (head + 3, head + 4), (head + 127, head + 128),
             (head + 1, head + 129), (0, m - 1)]
    pairs = [(i, j) for i, j in pairs if 0 <= i < j < m]
    a = torch.full((1, len(pairs) + 1, m), -5.0)
    for r, (i, j) in enumerate(pairs):
        a[0, r, [j, i]] = 7.0
    a[0, -1, :] = 1.0
    pc = torch.zeros(1, m, device=cuda)
    if fused:  # tb = 0: the benefit is -cost
        cost = _offset_copy(-a, offset, cuda)
        best_v, best_j, second = lap_bid_fused_batched(cost, pc, torch.zeros(1, device=cuda))
    else:
        best_v, best_j, second = lap_bid_batched(_offset_copy(a, offset, cuda), pc)
    assert best_j.cpu().tolist() == [[i for i, _ in pairs] + [0]]
    assert torch.equal(second.cpu(), best_v.cpu())


@pytest.mark.parametrize("change", ["grid_x", "row_tiles", "rows", "block"])
def test_migration_cost_entry_refuses_a_geometry_that_misses_cells(cuda, change):
    """The entry point launches the geometry it is given, so it refuses one
    that leaves a cell unwritten (a column block or a row tile short), rows
    per thread it is not built for and a block past its launch bounds."""
    u, v = 300, 700
    geo = mc.launch_geometry(u, v)
    tx, ty = geo.block
    grid_x, grid_y = geo.grid
    rows, row_tiles = geo.rows, geo.row_tiles
    if change == "grid_x":
        grid_x -= 1
    elif change == "row_tiles":
        row_tiles -= 1
    elif change == "rows":
        rows = 3
    else:
        ty *= 2
    su = torch.zeros((u, 2), dtype=torch.int32, device=cuda)
    sv = torch.zeros((v, 2), dtype=torch.int32, device=cuda)
    wu = torch.zeros((u, 2), dtype=torch.float64, device=cuda)
    wv = torch.zeros((v, 2), dtype=torch.float64, device=cuda)
    out = torch.empty((u, v), dtype=torch.float64, device=cuda)
    fn = build.library("migration_cost").migration_cost
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = fn(su.data_ptr(), sv.data_ptr(), wu.data_ptr(), wv.data_ptr(), out.data_ptr(), u, v,
             tx, ty, rows, row_tiles, grid_x, grid_y, torch.cuda.current_stream().cuda_stream,
             None, None)
    assert err != 0


def _padded_slots(count, g, shift):
    """(count, 2) slots cycling through all 16 patterns of a real id (0..5,
    so GPUs share jobs) or a padding id -1/-2/-3 in each of the two slots."""
    real = torch.randint(0, 6, (count, 2), generator=g, dtype=torch.int32)
    pattern = (torch.arange(count) * 7 + shift) % 16
    code = torch.stack([pattern // 4, pattern % 4], dim=1).to(torch.int32)
    return torch.where(code == 0, real, -code)


@pytest.mark.parametrize("weights", ["gathered", "every slot"])
@pytest.mark.parametrize("u,v", [(2048, 2048), (2047, 2049), (1, 5), (5, 1), (48, 48)])
def test_migration_cost_kernel_padding_ids_and_odd_widths(cuda, u, v, weights):
    """Every -1/-2/-3 padding pattern against every other, at odd V (rows
    shifted by one cell, a scalar head or tail): bit for bit against the
    plain version.  ``every slot`` gives padding slots a weight too, and
    non-dyadic ones, so the operation order decides every bit."""
    g = torch.Generator().manual_seed(u * 3 + v)
    su, sv = _padded_slots(u, g, 0), _padded_slots(v, g, 5)
    if weights == "gathered":
        w = torch.tensor([0.5, 0.25, 0.125, 0.0625], dtype=torch.float64)
        wu = torch.where(su < 0, 0.0, w[su.clamp_min(0) % 4])
        wv = torch.where(sv < 0, 0.0, w[sv.clamp_min(0) % 4])
    else:
        wu = torch.rand((u, 2), generator=g, dtype=torch.float64) / 3.0
        wv = torch.rand((v, 2), generator=g, dtype=torch.float64) / 7.0
    _poison_next_blocks(cuda, 2 * u * v)
    got = migration_cost(su.to(cuda), sv.to(cuda), wu.to(cuda), wv.to(cuda)).cpu()
    want = migration_cost_plain(su, sv, wu, wv)
    assert torch.equal(want.view(torch.int64), got.view(torch.int64))


def test_migration_cost_kernel_takes_offset_views(cuda):
    """Operands that are contiguous views past a 16-byte boundary (the
    kernel's vector loads need it) are copied to an aligned base first."""
    g = torch.Generator().manual_seed(7)
    su, sv = _padded_slots(33, g, 1), _padded_slots(31, g, 2)
    wu = torch.rand((33, 2), generator=g, dtype=torch.float64)
    wv = torch.rand((31, 2), generator=g, dtype=torch.float64)
    views = [_offset_copy(t, 1, cuda) for t in (su, sv, wu, wv)]
    assert all(t.data_ptr() % 16 for t in views)
    got = migration_cost(*views).cpu()
    assert torch.equal(migration_cost_plain(su, sv, wu, wv).view(torch.int64), got.view(torch.int64))


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


def test_packing_on_card_takes_the_exact_answer_solved_ahead(cuda):
    """A packing-shaped rectangle (175 placed by 2,000 pending jobs of 7
    model types, so weights tie): a cold round, then three that each churn
    5 jobs and stale the last auction's unassigned prices, so each adopts
    the exact answer.  From the second of them the exact re-solve comes
    from the host worker, run while the card bids; the plans are the CPU
    path's bit for bit."""
    rounds = packing_replay(0, 4, 175, 2000, models=7, churn=5)
    before = lap_auction.launches
    on_card, fb_card = traced_packing(rounds, "auction_kernel", cuda)
    assert lap_auction.launches == before + 4
    on_cpu, fb_cpu = traced_packing(rounds, "auction_kernel", "cpu")
    for rg, rc in zip(on_card, on_cpu):
        np.testing.assert_array_equal(rg.col_of, rc.col_of)
        np.testing.assert_array_equal(rg.total_cost, rc.total_cost)
        np.testing.assert_array_equal(rg.bid_iters, rc.bid_iters)
        np.testing.assert_array_equal(rg.used_fallback, rc.used_fallback)
    assert [r.used_fallback[0] for r in on_card] == [False, True, True, True]
    assert fb_card[0] is None and fb_cpu[0] is None
    assert [fb["ahead"] for fb in fb_card[1:]] == [fb["ahead"] for fb in fb_cpu[1:]] == [0, 1, 1]


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


@pytest.mark.parametrize("d", [80, 96, 192])
def test_sdpa_at_a_head_dim_without_a_kernel_runs_the_einsum_path(cuda, monkeypatch, d):
    """Unset, a causal sdpa at head dim 96 (K6 has no instance) runs the
    einsum path on the card and matches the CPU's (2e-5, f32), and
    ``REPRO_USE_FLASH=1`` asks for the kernel there and raises.  At 80
    (zamba2's shared block, the padded instance) and 192 (nemotron-4's) K6
    has an instance: unset, sdpa launches it, in bf16 within 3e-2 of the
    einsum path and in f32 within 2e-5 of the CPU's."""
    from repro_torch.models.attention import sdpa

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    kernel = d != 96
    q, k, v = _attn_inputs(4, 1, 96, 4, 2, d, torch.float32)
    want = sdpa(q, k, v, causal=True)
    before = flash_attention.launches
    got = sdpa(q.to(cuda), k.to(cuda), v.to(cuda), causal=True)
    assert flash_attention.launches == before + kernel
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    if kernel:
        qb, kb, vb = (t.to(cuda, torch.bfloat16) for t in (q, k, v))
        flash = sdpa(qb, kb, vb, causal=True)
        assert flash_attention.launches == before + 2
        monkeypatch.setenv("REPRO_USE_FLASH", "0")
        einsum = sdpa(qb, kb, vb, causal=True)
        torch.testing.assert_close(flash.float(), einsum.float(), rtol=3e-2, atol=3e-2)
        return
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
    """valid_len at, just below and just past the end of a split's tiles (the
    f32 instance's split edge, from its launch plan), and read on the device
    from a 0-d tensor; slots past it are ignored."""
    b, h, kv, s, d = 1, 8, 2, 8192, 128
    q, k, v = _decode_inputs(11, b, h, kv, s, d, torch.float32)
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    assert plan["instance"] == "ffma_f32" and plan["splits"] > 1
    edge = plan["tiles_per_split"] * plan["tile"]
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
# K6 / K7: the Hopper designs' tile edges (bf16 on wgmma + TMA for K6, K7's
# bf16 mma.sync instance behind its cp.async ring), compared on the card with
# the plain versions
# --------------------------------------------------------------------------- #
def _cuda_attn(seed, b, s, h, kv, d, dtype, device):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g, device=device).to(dtype)
    k = torch.randn((b, s, kv, d), generator=g, device=device).to(dtype)
    v = torch.randn((b, s, kv, d), generator=g, device=device).to(dtype)
    return q, k, v


@pytest.mark.parametrize("g", [1, 4, 5, 6, 8])  # 5: qwen3-14b's 40/8, 6: dbrx's 48/8
@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 255, 256, 257, 1000, 4113])
def test_flash_attention_bf16_tile_edges(cuda, s, causal, d, g):
    """S on both sides of the 128-row query and key tiles (TMA zero-fills
    past S; those keys are masked from their indices; at D = 192 the key
    tiles are 64 wide), D over one, two or three 64-wide swizzled panels
    (80: the second panel zero-filled past column 80), G query heads per KV
    head at B = 2."""
    q, k, v = _cuda_attn(s * 7 + d + g, 2, s, 2 * g, 2, d, torch.bfloat16, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("d", [64, 80, 128, 192])
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


@pytest.mark.parametrize("d", [128, 192])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_rescale_when_the_max_is_in_the_last_tile(cuda, causal, d):
    """Query rows that find their maximum only in the last key tile they
    see (the second of two at D 128, the fourth of four 64-key tiles at D
    192): the running max jumps there, and the accumulator of the earlier
    tiles must be rescaled by it.  Non-causal: rows of the first query tile
    against keys 128 later; causal: rows of the second query tile against
    their own (diagonal) key."""
    s = 256
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


@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_repeats_bitwise(cuda, causal, d):
    """The consumer warpgroups take turns by named barriers and run their
    softmax under each other's GEMMs, and the producer loads the next work
    item under this one: nothing of the result may depend on that timing,
    so one call made again gives the same bits (many query and key tiles,
    G 4)."""
    q, k, v = _cuda_attn(d + causal, 2, 1000, 8, 2, d, torch.bfloat16, cuda)
    got = flash_attention(q, k, v, causal)
    for _ in range(3):
        assert torch.equal(flash_attention(q, k, v, causal), got)
    want = flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_grid_under_one_wave(cuda, causal, d):
    """(1, 256, 2 / 1 KV heads): four work items, so a persistent grid of
    four CTAs on a card of 132 SMs whose walk ends after one round, each
    item with up to two query tiles' worth of key tiles (four at D 192)."""
    q, k, v = _cuda_attn(3 * d, 1, 256, 2, 1, d, torch.bfloat16, cuda)
    from repro_torch.kernels.flash_attention import launch_plan

    plan = launch_plan(q.shape, 1, q.dtype, sms=torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan["items"] == 4 and plan["grid"] == (4,)
    got = flash_attention(q, k, v, causal)
    want = flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("d", [64, 80, 128, 192])
def test_flash_attention_bf16_non_causal_rows_of_both_warpgroups_peak_in_every_tile(cuda, d):
    """Non-causal, so both consumer warpgroups run every key tile: the rows
    of each warpgroup (the first and second 64 of a query tile) have their
    maximum planted in a different key tile each, from the first to the
    last, so the running max moves in every tile of both warpgroups' turns."""
    s = 640
    q, k, v = _cuda_attn(11 * d, 1, s, 2, 1, d, torch.bfloat16, cuda)
    rows = torch.arange(0, s, 37, device=cuda)
    keys = (rows * 97) % s  # rows in both halves of every query tile, keys in every tile
    k[0, keys, 0] = q[0, rows, 0]
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)
    scores = q[0, rows, 0].float() @ k[0, :, 0].float().T
    assert bool((scores.argmax(-1) == keys).all())  # the maximum does sit there
    assert {int(r) % 128 >= 64 for r in rows} == {False, True}
    assert len({int(j) // 64 for j in keys}) == s // 64


@pytest.mark.parametrize("d", [64, 80, 128, 192])
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


@pytest.mark.parametrize("g", [1, 4, 12])  # 12: nemotron-4's 96/8
@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 1000])
def test_flash_attention_f32_tile_edges(cuda, s, causal, d, g):
    """The f32 instance at S on both sides of its 128-row query tiles and
    its K/V tiles (64 keys, 32 at D = 192: zero-filled past S, those keys
    masked from their indices), S = 1, G query heads per KV head at B = 2,
    within 2e-5 of the plain version."""
    q, k, v = _cuda_attn(s * 7 + d + g + 1, 2, s, 2 * g, 2, d, torch.float32, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("s", [257, 1000])
def test_flash_attention_f32_reads_fused_qkv_views(cuda, s, d):
    """q, k and v as strided views of one f32 (B, S, H + 2 KV, D)
    projection: the kernel reads through their strides, no copy is made."""
    b, h, kv = 2, 8, 2
    gen = torch.Generator(device=cuda).manual_seed(3 * s + d)
    x = torch.randn((b, s, h + 2 * kv, d), generator=gen, device=cuda)
    q, k, v = x[:, :, :h], x[:, :, h:h + kv], x[:, :, h + kv:]
    assert build.aligned_view(q).data_ptr() == q.data_ptr()  # read in place
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_repeats_bitwise(cuda, causal, d):
    """One f32 call made again gives the same bits (many query and key
    tiles, G 4), within 2e-5 of the plain version."""
    q, k, v = _cuda_attn(5 * d + causal, 2, 1000, 8, 2, d, torch.float32, cuda)
    got = flash_attention(q, k, v, causal)
    for _ in range(3):
        assert torch.equal(flash_attention(q, k, v, causal), got)
    want = flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [64, 80, 128, 192])
def test_flash_attention_f32_non_causal_rows_peak_in_every_tile(cuda, d):
    """Non-causal f32: rows of every warp's row groups have their maximum
    planted in a different K/V tile each, from the first to the last, so
    the running max moves and O is rescaled in every tile."""
    s = 640
    q, k, v = _cuda_attn(13 * d, 1, s, 2, 1, d, torch.float32, cuda)
    rows = torch.arange(0, s, 19, device=cuda)  # rows of every row group of a warp
    keys = (rows * 97) % s
    k[0, keys, 0] = q[0, rows, 0]
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    scores = q[0, rows, 0] @ k[0, :, 0].T
    assert bool((scores.argmax(-1) == keys).all())  # the maximum does sit there
    assert {int(r) % 16 for r in rows} == set(range(16))
    assert len({int(j) // 32 for j in keys}) == s // 32


_RING = {64: 3 * 64, 80: 3 * 64, 128: 2 * 64, 192: 2 * 64}  # slots in a full ring of the bf16 kernel


@pytest.mark.parametrize("single_split", [True, False])
@pytest.mark.parametrize("g", [1, 4, 5, 6, 8, 12])  # 12: nemotron-4's 96/8
@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("valid", ["0", "1", "63", "64", "65", "ring+1", "2ring+1", "S"])
def test_flash_decode_bf16_ring_edges(cuda, valid, d, g, single_split):
    """valid_len at 0, one slot, both sides of a 64-slot tile, one and two
    ring wraps past a stage boundary and the whole cache; as the wrapper
    splits it and with B = 1 in one split that walks every tile."""
    s, kv = 1024, 2
    n = {"0": 0, "1": 1, "63": 63, "64": 64, "65": 65, "ring+1": _RING[d] + 1,
         "2ring+1": 2 * _RING[d] + 1, "S": s}[valid]
    b = 1 if single_split else 2
    gen = torch.Generator(device=cuda).manual_seed(n + d + g)
    q = torch.randn((b, g * kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    assert plan["instance"] == "mma_bf16" and fd.mma_stages(d) * 64 == _RING[d]
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


# --------------------------------------------------------------------------- #
# K6 / K7 at head dim 80 (zamba2's shared block): the padded bf16 instance
# of K6, K7's mma instance on rows padded to 11 chunks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 200, 8192])
def test_flash_attention_d80_matches_plain(cuda, s, causal, g, dtype):
    """f32 within 2e-5 of the plain version; bf16 within 3e-2 and, per
    128-query tile, within 1e-2 relative L2 error (the smoke's gate)."""
    q, k, v = _cuda_attn(s + g + causal, 1, s, 2 * g, 2, 80, dtype, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        d2 = (got.float() - want.float()).square().sum((2, 3))
        w2 = want.float().square().sum((2, 3))
        pad = (-s) % 128
        d2, w2 = (torch.nn.functional.pad(x, (0, pad)).reshape(1, -1, 128).sum(-1) for x in (d2, w2))
        assert float((d2 / w2.clamp_min(1e-30)).sqrt().max()) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,valid", [(8, 32, 32, 8192, 63), (2, 8, 2, 1000, 0), (2, 8, 2, 1000, 1),
                                            (3, 4, 4, 300, 257), (1, 16, 4, 4096, 4001),
                                            (2, 6, 2, 640, 640)])
def test_flash_decode_d80_matches_plain(cuda, dtype, b, h, kv, s, valid):
    """valid_len 0 (zeros), one slot, ragged lengths and the whole cache,
    the first row the zamba2 serving shape; slots past valid_len unread."""
    q, k, v = (t.to(cuda) for t in _decode_inputs(s + valid + h, b, h, kv, s, 80, dtype))
    before = flash_decode.launches
    got = flash_decode(q, k, v, torch.tensor(valid, device=cuda))
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    want = flash_decode_plain(q, k, v, valid)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if valid == 0:
        assert not got.any()
    k2, v2 = k.clone(), v.clone()
    k2[:, valid:] = 1e4
    v2[:, valid:] = -1e4
    torch.testing.assert_close(flash_decode(q, k2, v2, valid), got, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# K6 / K7 at head dim 192 (nemotron-4-340b): K6's bf16 instance with 64-key
# K/V tiles and an n192 P V, K7's tensor-core instance (mma::)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 12])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 200, 8192])
def test_flash_attention_d192_matches_plain(cuda, s, causal, g, dtype):
    """f32 within 2e-5 of the plain version; bf16 within 3e-2 and, per
    128-query tile, within 1e-2 relative L2 error (the smoke's gate); G 12
    is nemotron-4's group."""
    q, k, v = _cuda_attn(s + g + causal + 192, 1, s, g, 1, 192, dtype, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        d2 = (got.float() - want.float()).square().sum((2, 3))
        w2 = want.float().square().sum((2, 3))
        pad = (-s) % 128
        d2, w2 = (torch.nn.functional.pad(x, (0, pad)).reshape(1, -1, 128).sum(-1) for x in (d2, w2))
        assert float((d2 / w2.clamp_min(1e-30)).sqrt().max()) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,valid", [(8, 96, 8, 8192, 63), (2, 24, 2, 1000, 0), (2, 24, 2, 1000, 1),
                                            (3, 12, 1, 300, 257), (1, 4, 4, 4096, 4001),
                                            (2, 2, 2, 640, 640)])
def test_flash_decode_d192_matches_plain(cuda, dtype, b, h, kv, s, valid):
    """Group 12 (nemotron-4's, 12 of a warp's 16 M rows) and group 1; valid_len 0
    (zeros), one slot, ragged lengths and the whole cache, the first row the
    (e7) serving shape; slots past valid_len unread."""
    q, k, v = (t.to(cuda) for t in _decode_inputs(s + valid + h, b, h, kv, s, 192, dtype))
    before = flash_decode.launches
    got = flash_decode(q, k, v, torch.tensor(valid, device=cuda))
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    want = flash_decode_plain(q, k, v, valid)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if valid == 0:
        assert not got.any()
    k2, v2 = k.clone(), v.clone()
    k2[:, valid:] = 1e4
    v2[:, valid:] = -1e4
    torch.testing.assert_close(flash_decode(q, k2, v2, valid), got, rtol=0, atol=0)


@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("g", [1, 2, 3, 12, 16])
@pytest.mark.parametrize("valid", [15, 16, 17, 48, 49, 64 + 17, 1000])
def test_flash_decode_mma_warp_slices(cuda, valid, g, d):
    """The tensor-core instance at every head dim: valid_len on both sides of
    a warp's 16-slot slice (15-17, 48-49; 81 in the second tile, 1000 in the
    last), groups 1-16 (zero M rows past G but at 16): within 3e-2 of the
    plain version and 1e-2 relative L2 error per head; slots past valid_len
    unread; a second launch gives the same bits."""
    b, kv, s = 2, 2, 1024
    gen = torch.Generator(device=cuda).manual_seed(31 * valid + g)
    q = torch.randn((b, g * kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    assert plan["instance"] == "mma_bf16" and plan["heads_per_warp"] == g
    before = flash_decode.launches
    got = flash_decode(q, k, v, torch.tensor(valid, device=cuda))
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    want = flash_decode_plain(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)
    rel = ((got.float() - want.float()).square().sum(-1) / want.float().square().sum(-1)).sqrt()
    assert float(rel.max()) <= 1e-2
    assert torch.equal(flash_decode(q, k, v, valid), got)
    k2, v2 = k.clone(), v.clone()
    k2[:, valid:] = 1e4
    v2[:, valid:] = -1e4
    torch.testing.assert_close(flash_decode(q, k2, v2, valid), got, rtol=0, atol=0)


def test_flash_decode_d192_mma_whole_cache_is_deterministic(cuda):
    """nemotron-4's group over a whole 32768-slot cache (B 2 x 2 KV heads:
    64 splits of 8 tiles, 256 blocks): the gate, and bitwise the same
    output on repeated launches."""
    b, h, kv, s, d = 2, 24, 2, 32768, 192
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(torch.bfloat16)
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    assert plan["instance"] == "mma_bf16" and (plan["splits"], plan["blocks"]) == (64, 256)
    got = flash_decode(q, k, v, s)
    want = flash_decode_plain(q, k, v, s)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)
    rel = ((got.float() - want.float()).square().sum(-1) / want.float().square().sum(-1)).sqrt()
    assert float(rel.max()) <= 1e-2
    for _ in range(3):
        assert torch.equal(flash_decode(q, k, v, s), got)


@pytest.mark.parametrize("d,g,per_sm", [(64, 1, 4), (64, 4, 4), (80, 1, 3), (80, 2, 3), (128, 4, 3),
                                         (128, 16, 3), (192, 1, 2), (192, 12, 2)])
def test_flash_decode_plan_blocks_per_sm_match_the_card(cuda, d, g, per_sm):
    """The bf16 instance's blocks per SM in the plan (by its shared memory
    and launch bounds) are the occupancy calculator's at every head dim."""
    plan = fd.launch_plan((1, 2 * g, d), (1, 512, 2, d), torch.bfloat16)
    assert plan["blocks_per_sm"] == per_sm
    assert fd.card_blocks_per_sm(plan, d) == per_sm


# --------------------------------------------------------------------------- #
# K7's f32 instance (ffma::): every head dim, groups 1 / 5 / 12 / 32 (32: two
# chunks of 16 on the grid's z axis, three of 12 at D 192), valid_len at its
# ring's and splits' edges
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("g", [1, 5, 12, 32])
@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("valid", ["0", "1", "stage+1", "split-1", "split+1", "S"])
def test_flash_decode_f32_edges(cuda, valid, d, g):
    """valid_len 0 (zeros), one slot, one past a full ring of 32-slot tiles,
    both sides of a split's last slot and the whole cache: within 2e-5 of
    the plain version; a second call gives the same bits; slots past
    valid_len (set to +-1e4) change nothing."""
    b, kv, s = 2, 2, 4096
    gen = torch.Generator(device=cuda).manual_seed(d + 7 * g)
    q = torch.randn((b, g * kv, d), generator=gen, device=cuda)
    k = torch.randn((b, s, kv, d), generator=gen, device=cuda)
    v = torch.randn((b, s, kv, d), generator=gen, device=cuda)
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    assert plan["instance"] == "ffma_f32" and plan["chunks"] == -(-g // fd.ffma_max_group(d))
    edge = plan["tiles_per_split"] * plan["tile"]
    assert plan["splits"] > 1 and edge < s
    n = {"0": 0, "1": 1, "stage+1": fd.ffma_stages(d) * plan["tile"] + 1, "split-1": edge - 1,
         "split+1": edge + 1, "S": s}[valid]
    before = flash_decode.launches
    got = flash_decode(q, k, v, torch.tensor(n, device=cuda))
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    torch.testing.assert_close(got, flash_decode_plain(q, k, v, n), rtol=2e-5, atol=2e-5)
    if n == 0:
        assert not got.any()
    assert torch.equal(flash_decode(q, k, v, n), got)
    k2, v2 = k.clone(), v.clone()
    k2[:, n:] = 1e4
    v2[:, n:] = -1e4
    assert torch.equal(flash_decode(q, k2, v2, n), got)


def test_flash_decode_f32_whole_cache_is_deterministic(cuda):
    """nemotron-4's group 12 at D 192 over a whole 16384-slot cache (B 2 x 2
    KV heads: 64 splits of 8 tiles, 256 blocks in one wave of 264): within
    2e-5, and bitwise the same output on repeated launches."""
    b, h, kv, s, d = 2, 24, 2, 16384, 192
    q, k, v = (t.to(cuda) for t in _decode_inputs(5, b, h, kv, s, d, torch.float32))
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    assert (plan["splits"], plan["tiles_per_split"], plan["blocks"]) == (64, 8, 256)
    got = flash_decode(q, k, v, s)
    torch.testing.assert_close(got, flash_decode_plain(q, k, v, s), rtol=2e-5, atol=2e-5)
    for _ in range(3):
        assert torch.equal(flash_decode(q, k, v, s), got)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 12, 16])
@pytest.mark.parametrize("d", [64, 80, 128, 192])
def test_flash_decode_f32_plan_blocks_per_sm_match_the_card(cuda, d, g):
    """The f32 instance's blocks per SM in the plan (by its shared memory and
    launch bounds: 3 at D 64, 2 elsewhere) are the occupancy calculator's,
    at every chunk size (at D 192 a group of 16 runs in chunks of 12)."""
    plan = fd.launch_plan((1, 2 * g, d), (1, 512, 2, d), torch.float32)
    assert plan["heads_per_warp"] == (12 if (d, g) == (192, 16) else g)
    assert plan["blocks_per_sm"] == (3 if d == 64 else 2)
    assert fd.card_blocks_per_sm(plan, d) == plan["blocks_per_sm"]


def test_nemotron_at_head_dim_192_on_card_equals_cpu_in_f32(cuda, monkeypatch):
    """The reduced nemotron-4 at its full head dim 192, f32, env unset: the
    card's forward (K6's f32 instance at D 192 in both layers) within 1e-4
    of the CPU's einsum forward, and 8 decode steps at batch 2 within 1e-4,
    with the caches."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import get_model

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    cfg = dataclasses.replace(get_reduced("nemotron-4-340b"), head_dim=192, dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    card_params = _to(params, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=torch.Generator().manual_seed(3))
    want, _ = model.forward(params, cfg, {"tokens": tokens})
    before = flash_attention.launches
    got, _ = model.forward(card_params, cfg, {"tokens": tokens.to(cuda)})
    assert flash_attention.launches - before == cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    hc, cc = model.init_cache(cfg, 2, 16, "cpu"), model.init_cache(cfg, 2, 16, cuda)
    for i in range(8):
        t = tokens[:, i:i + 1]
        hl, hc = model.decode_step(params, cfg, {"tokens": t}, hc, i)
        cl, cc = model.decode_step(card_params, cfg, {"tokens": t.to(cuda)}, cc, i)
        torch.testing.assert_close(cl.cpu(), hl, rtol=1e-4, atol=1e-4)
    for h_, c_ in zip(hc["layers"], cc["layers"], strict=True):
        for key in h_:
            torch.testing.assert_close(c_[key].cpu(), h_[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_widths_launch_nothing_on_card(cuda, monkeypatch, dtype):
    """q/k at head dim 192 and v at 128 (MLA's): K6 has an instance at 192,
    but v's head dim differs, so unset, sdpa takes the einsum path on the
    card (no launch; equal to the CPU's in f32 at 2e-5), and
    ``REPRO_USE_FLASH=1`` raises as the reference does (F7)."""
    from repro_torch.models.attention import sdpa

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    g = torch.Generator().manual_seed(6)
    q, k = (torch.randn((1, 96, 4, 192), generator=g) for _ in range(2))
    v = torch.randn((1, 96, 4, 128), generator=g)
    before = flash_attention.launches
    got = sdpa(*(t.to(cuda, dtype) for t in (q, k, v)), causal=True)
    assert flash_attention.launches == before and got.shape == (1, 96, 4, 128)
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), sdpa(q, k, v, causal=True), rtol=2e-5, atol=2e-5)
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    with pytest.raises(ValueError, match="k/v shapes differ"):
        sdpa(*(t.to(cuda, dtype) for t in (q, k, v)), causal=True)
    assert flash_attention.launches == before


# --------------------------------------------------------------------------- #
# the SSM and hybrid families on the card
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_and_hybrid_forward_and_decode_on_card_equal_cpu_in_f32(cuda, monkeypatch, arch):
    """The reduced mamba2 / zamba2 in f32, env unset: the card's forward
    logits within 1e-4 of the CPU's (zamba2's shared block on K6's f32
    instance, once per application; mamba2 launches nothing), and 8 decode
    steps at batch 2 within 1e-4, with both cache parts."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import get_model

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    card_params = _to(params, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2 * cfg.ssm_chunk),
                           generator=torch.Generator().manual_seed(2))
    want, _ = model.forward(params, cfg, {"tokens": tokens})
    before = flash_attention.launches
    got, _ = model.forward(card_params, cfg, {"tokens": tokens.to(cuda)})
    applications = cfg.num_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    assert flash_attention.launches - before == applications
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    hc, cc = model.init_cache(cfg, 2, 16, "cpu"), model.init_cache(cfg, 2, 16, cuda)
    for i in range(8):
        t = tokens[:, i:i + 1]
        hl, hc = model.decode_step(params, cfg, {"tokens": t}, hc, i)
        cl, cc = model.decode_step(card_params, cfg, {"tokens": t.to(cuda)}, cc, i)
        torch.testing.assert_close(cl.cpu(), hl, rtol=1e-4, atol=1e-4)
    for part in ("layers", "shared"):
        for h_, c_ in zip(hc.get(part, []), cc.get(part, []), strict=True):
            for key in h_:
                torch.testing.assert_close(c_[key].cpu(), h_[key], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# the encoder-decoder on the card
# --------------------------------------------------------------------------- #
def test_encoder_decoder_forward_and_decode_on_card_equal_cpu_in_f32(cuda, monkeypatch):
    """The reduced seamless-m4t in f32, env unset: the card's forward (the
    decoder's causal self-attention on K6's f32 instance at D 64, once a
    decoder layer; the encoder and the cross-attention on the einsum path)
    within 1e-4 of the CPU's; the cross K/V of ``prefill_cross`` within
    1e-5; 8 decode steps at batch 2 against them within 1e-4 of the CPU's
    and of the forward, with the self-attention caches; the card's greedy
    steps (zero cross K/V) within 1e-4 of its forward on zero frames (D15)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import encdec, get_model
    from repro_torch.serve import ServeConfig, greedy_generate

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    cfg = dataclasses.replace(get_reduced("seamless-m4t-medium"), dtype="float32")
    model = get_model(cfg)
    assert model is encdec
    params = model.init(torch.Generator().manual_seed(0), cfg)
    card_params = _to(params, cuda)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=g)
    frames = torch.randn((2, cfg.frontend_len, cfg.d_model), generator=g) * 0.02
    want, _ = model.forward(params, cfg, {"tokens": tokens, "audio_frames": frames})
    before = flash_attention.launches
    got, _ = model.forward(card_params, cfg, {"tokens": tokens.to(cuda),
                                              "audio_frames": frames.to(cuda)})
    assert flash_attention.launches - before == cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    hc, cc = model.init_cache(cfg, 2, 16, "cpu"), model.init_cache(cfg, 2, 16, cuda)
    hc["cross_k"], hc["cross_v"] = encdec.prefill_cross(params, cfg, encdec.encode(params, cfg, frames))
    cc["cross_k"], cc["cross_v"] = encdec.prefill_cross(
        card_params, cfg, encdec.encode(card_params, cfg, frames.to(cuda)))
    for key in ("cross_k", "cross_v"):
        torch.testing.assert_close(cc[key].cpu(), hc[key], rtol=1e-5, atol=1e-5)
    for i in range(8):
        t = tokens[:, i:i + 1]
        hl, hc = model.decode_step(params, cfg, {"tokens": t}, hc, i)
        cl, cc = model.decode_step(card_params, cfg, {"tokens": t.to(cuda)}, cc, i)
        torch.testing.assert_close(cl.cpu(), hl, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(cl.cpu(), want[:, i:i + 1], rtol=1e-4, atol=1e-4)
    for h_, c_ in zip(hc["layers"], cc["layers"], strict=True):
        for key in h_:
            torch.testing.assert_close(c_[key].cpu(), h_[key], rtol=1e-5, atol=1e-5)
    seq, steps = greedy_generate(card_params, cfg, tokens[:, :4].to(cuda), 8, ServeConfig(2, 16),
                                 return_logits=True)
    zeros = torch.zeros_like(frames, device=cuda)
    full, _ = model.forward(card_params, cfg, {"tokens": seq, "audio_frames": zeros})
    torch.testing.assert_close(steps, full[:, :-1], rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# training on the card: the einsum path under autograd (ROADMAP D8)
# --------------------------------------------------------------------------- #
def _train_step_on(device, cfg, microbatches=1):
    from repro_torch.train.data import batch_for, to_device
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.step import TrainConfig, make_train_step, train_state_init

    tc = TrainConfig(microbatches=microbatches)
    state = tree_map(lambda t: t.to(device),
                     train_state_init(torch.Generator().manual_seed(0), cfg, tc))
    batch = batch_for(cfg.vocab_size, 2, 64, seed=0, step=0, frontend=cfg.frontend,
                      frontend_len=cfg.frontend_len, d_model=cfg.d_model)
    return make_train_step(cfg, tc)(state, to_device(batch, device))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_on_card_equals_cpu_in_f32(cuda, monkeypatch, microbatches):
    """One reduced-config f32 step on the card: the metrics, the moments
    (the gradients) and the params within 1e-5 relative L2 of the CPU's
    (params over the elements where Adam's step is well conditioned,
    |g| >= 100 eps, and within a quarter step elsewhere, as
    ``test_torch_train.py`` holds the CPU to the JAX package); no flash
    launch (unset, attention under autograd takes the einsum path)."""
    import dataclasses

    from repro_torch.configs import get_reduced

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    cfg = dataclasses.replace(get_reduced("llama3-8b"), dtype="float32")
    before = flash_attention.launches
    card, mc = _train_step_on(cuda, cfg, microbatches)
    assert flash_attention.launches == before
    host, mh = _train_step_on("cpu", cfg, microbatches)
    for k in ("loss", "nll", "z_loss", "grad_norm"):
        assert abs(float(mc[k]) - float(mh[k])) <= 1e-5 * abs(float(mh[k])), k
    def rel(g, w):
        scale = float(w.norm())
        return float((g - w).norm()) / (scale if scale > 0 else 1.0)

    for (path, g), (_, w) in zip(_paths(card["opt"]), _paths(host["opt"]), strict=True):
        assert rel(g.cpu().float(), w.float()) <= 1e-5, path
    lr = 3e-4 / 100  # the default schedule's first step
    for (path, g), (_, w), (_, m) in zip(_paths(card["params"]), _paths(host["params"]),
                                         _paths(host["opt"]["m"]), strict=True):
        g, w = g.cpu().float(), w.float()
        ill = m.float().abs() / 0.1 < 100 * 1e-8
        assert rel(g[~ill], w[~ill]) <= 1e-5, path
        assert not ill.any() or float(((g - w).abs() - 1e-5 * w.abs())[ill].max()) <= lr / 4, path


def test_train_step_on_card_gives_wq_wk_wv_a_gradient(cuda, monkeypatch):
    """R1 on the card: under the default routing every layer's wq/wk/wv
    gets a nonzero gradient (read from the first moment after one step from
    zero, m = (1 - beta1) * clipped grad), in the model's bf16."""
    from repro_torch.configs import get_reduced

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    state, _ = _train_step_on(cuda, get_reduced("llama3-8b"))
    for path, m in _paths(state["opt"]["m"]):
        assert m.abs().max() > 0, path
    for layer in state["opt"]["m"]["layers"]:
        for name in ("wq", "wk", "wv"):
            assert layer["attn"][name].abs().max() > 0, name


def test_flash_forced_under_grad_raises_on_card(cuda, monkeypatch):
    from repro_torch.models.attention import sdpa

    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    q, k, v = (t.to(cuda) for t in _attn_inputs(5, 1, 96, 4, 2, 64, torch.bfloat16))
    before = flash_attention.launches
    sdpa(q, k, v, causal=True)  # nothing records: the kernel
    assert flash_attention.launches == before + 1
    with pytest.raises(RuntimeError, match="no backward"):
        sdpa(q.requires_grad_(), k, v, causal=True)
    assert flash_attention.launches == before + 1


def test_checkpoint_round_trip_from_card_tensors(cuda, tmp_path):
    """A state on the card saved and restored into a fresh state on the
    card: bitwise equal, every leaf back on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.step import TrainConfig, train_state_init

    cfg = get_reduced("llama3-8b")
    state, _ = _train_step_on(cuda, cfg)
    path = str(tmp_path / "card.npz")
    save_checkpoint(path, state, step=1)
    fresh = train_state_init(torch.Generator(device=cuda).manual_seed(9), cfg, TrainConfig())
    restored, at = restore_checkpoint(path, fresh)
    assert at == 1
    for (path_, g), (_, w) in zip(_paths(restored), _paths(state), strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w), path_


# --------------------------------------------------------------------------- #
# MoE and MLA on the card against the same on the CPU (f32)
# --------------------------------------------------------------------------- #
def _routes_of(monkeypatch):
    from repro_torch.models import mlp

    routes, real = [], mlp.moe_route
    monkeypatch.setattr(mlp, "moe_route", lambda *a: routes.append(real(*a)) or routes[-1])
    return routes


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
@pytest.mark.parametrize("groups", ["1", "2"])
def test_moe_ffn_on_card_equals_cpu_in_f32(cuda, monkeypatch, arch, groups):
    """The reduced config's MoE layer in f32 on tokens that overflow an
    expert: the card routes exactly as the CPU (experts, slots, keep), and
    its output is within 1e-5 of the CPU's."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import mlp

    monkeypatch.setenv("REPRO_MOE_GROUPS", groups)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    p = mlp.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    g = torch.Generator().manual_seed(1)
    r0 = p["router"][:, 0]
    x = torch.randn((2, 48, cfg.d_model), generator=g) + 3 * cfg.d_model**0.5 * r0 / r0.norm()
    routes = _routes_of(monkeypatch)
    want, waux = mlp.moe_ffn(p, cfg, x)
    on_card = {k: (v.to(cuda) if torch.is_tensor(v) else {kk: vv.to(cuda) for kk, vv in v.items()})
               for k, v in p.items()}
    got, gaux = mlp.moe_ffn(on_card, cfg, x.to(cuda))
    host, card = routes
    assert not bool(host["keep"].all())
    for key in ("experts", "pos", "keep"):
        assert torch.equal(card[key].cpu(), host[key]), key
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_model_forward_and_decode_on_card_equal_cpu_in_f32(cuda, monkeypatch, arch):
    """The reduced MoE / MLA model in f32: the card's forward logits within
    1e-4 of the CPU's with every layer routed the same, and 6 decode steps
    at batch 2 within 1e-4."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import get_model

    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    card_params = _to(params, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(2))
    routes = _routes_of(monkeypatch)
    want, waux = model.forward(params, cfg, {"tokens": tokens})
    got, gaux = model.forward(card_params, cfg, {"tokens": tokens.to(cuda)})
    host, card = routes[:cfg.num_layers], routes[cfg.num_layers:]
    for h, c in zip(host, card, strict=True):
        for key in ("experts", "pos", "keep"):
            assert torch.equal(c[key].cpu(), h[key]), key
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))
    hc, cc = model.init_cache(cfg, 2, 8, "cpu"), model.init_cache(cfg, 2, 8, cuda)
    for i in range(6):
        t = tokens[:, i:i + 1]
        hl, hc = model.decode_step(params, cfg, {"tokens": t}, hc, i)
        cl, cc = model.decode_step(card_params, cfg, {"tokens": t.to(cuda)}, cc, i)
        torch.testing.assert_close(cl.cpu(), hl, rtol=1e-4, atol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# --------------------------------------------------------------------------- #
# the initial state train_loop draws on the host
# --------------------------------------------------------------------------- #
def test_host_init_draws_the_same_bits_at_every_address_and_thread_count():
    """``train_loop`` draws its initial state on the host and moves it to
    the card, so the draw must not depend on where the buffer lies or how
    many threads fill it: the port's truncated normal, drawn from one seed
    into buffers at 64 addresses 4 bytes apart and under 1, 2 and 8 intra-op
    threads, gives the same bits every time.  Needs no card."""
    from repro_torch.models.layers import trunc_normal_

    n, threads = 256 * 4 * 64, torch.get_num_threads()
    buf = torch.empty(n + 64)
    first = trunc_normal_(buf[:n], torch.Generator().manual_seed(0)).clone()
    for i in range(1, 64):
        w = trunc_normal_(buf[i:i + n], torch.Generator().manual_seed(0))
        assert torch.equal(w, first), f"address {buf[i:].data_ptr() % 256} mod 256"
    try:
        for t in (1, 2, 8):
            torch.set_num_threads(t)
            assert torch.equal(trunc_normal_(buf[:n], torch.Generator().manual_seed(0)), first), t
    finally:
        torch.set_num_threads(threads)
