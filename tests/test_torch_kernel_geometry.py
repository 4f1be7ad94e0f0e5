"""How ``migration_cost.cu`` and ``lap_bid.cu`` cover their outputs, on the
CPU.

Each kernel's launch (grid, tile, lanes per row, the row divisor) is
decided by pure Python beside its wrapper (``migration_cost.launch_geometry``,
``lap_bid.launch_geometry``) and passed to the kernel's entry point.  Here
the index map it implies, with the kernels' own split of a row into
16-byte vector accesses and scalar heads and tails (:func:`row_split`, this
file's model of the loop in ``csrc/lap_bid.cu``), is simulated in numpy at
small and ragged shapes: every output cell or row is written exactly once,
every vector access falls on an address aligned to its width, and the grid
stays inside the launch limits.  On the card ``test_torch_cuda.py`` holds
the kernels to their plain versions bit for bit and the entry points'
refusal of a geometry that does not cover the output.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import lap_bid as lb
from repro_torch.kernels import migration_cost as mc
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

GRID_X_LIMIT = (1 << 31) - 1
GRID_Y_LIMIT = 65535
#: float4 chunks each lane has in flight per step (``kUnroll`` in ``csrc/lap_bid.cu``)
UNROLL = 4


def row_split(start: int, m: int):
    """``(head, chunks, tail)`` of a row of ``m`` f32 whose first element
    sits ``start`` elements past a 16-byte boundary (its address / 4 mod 4),
    as ``csrc/lap_bid.cu`` reads it: ``head`` scalar columns up to the
    boundary, ``chunks`` aligned float4 chunks, then ``tail`` scalar
    columns."""
    head = min(m, (4 - start % 4) % 4)
    chunks = (m - head) // 4
    return head, chunks, m - head - 4 * chunks


# --------------------------------------------------------------------------- #
# migration_cost: (U, V) f64 cells in 16-byte pairs
# --------------------------------------------------------------------------- #
def _tiles_of(geo):
    """Row tiles in the order each y-block loops over them."""
    return [t for by in range(geo.grid[1]) for t in range(by, geo.row_tiles, geo.grid[1])]


def _cost_stores(u_count, v_count, geo):
    """Every store the kernel issues: (u, v, cells) arrays, cells 2 for a
    double2 store and 1 for a scalar."""
    tx, ty = geo.block
    tile_rows = ty * geo.rows
    rows = np.array([t * tile_rows + r * ty + y for t in _tiles_of(geo)
                     for r in range(geo.rows) for y in range(ty)])
    rows = rows[rows < u_count]
    k = np.arange(geo.grid[0] * tx)
    k = k[2 * k < v_count]
    uu, kk = np.meshgrid(rows, k, indexing="ij")
    shifted = (v_count % 2 == 1) & (uu % 2 == 1)
    v = 2 * kk + shifted
    pair = v + 1 < v_count
    tail = ~pair & (v < v_count)
    head = shifted & (kk == 0)
    us = np.concatenate([uu[pair], uu[tail], uu[head]])
    vs = np.concatenate([v[pair], v[tail], np.zeros(int(head.sum()), np.int64)])
    cells = np.concatenate([np.full(int(pair.sum()), 2), np.ones(int(tail.sum() + head.sum()))])
    return us, vs, cells.astype(np.int64)


@pytest.mark.parametrize("v_count", [1, 2, 3, 257, 2048])
@pytest.mark.parametrize("u_count", [1, 2, 3, 257, 2048])
def test_migration_cost_covers_every_cell_once(u_count, v_count):
    geo = mc.launch_geometry(u_count, v_count)
    assert geo.grid[0] <= GRID_X_LIMIT and 1 <= geo.grid[1] <= GRID_Y_LIMIT
    assert geo.block[0] * geo.block[1] == mc.THREADS and geo.block[0] % 32 == 0
    assert geo.grid[0] * geo.block[0] >= geo.pairs > (geo.grid[0] - 1) * geo.block[0]
    assert sorted(_tiles_of(geo)) == list(range(geo.row_tiles))
    us, vs, cells = _cost_stores(u_count, v_count, geo)
    hits = np.zeros((u_count, v_count), np.int64)
    np.add.at(hits, (us, vs), 1)
    second = cells == 2
    np.add.at(hits, (us[second], vs[second] + 1), 1)
    assert (hits == 1).all()
    # a double2 store lands on a 16-byte boundary of the (aligned) output
    assert ((us[second] * v_count + vs[second]) * 8 % 16 == 0).all()
    # the v-side int4 load at slots + 16 k covers columns 2k and 2k + 1, so
    # it is taken only where both are in range (the int2 / double2 loads of
    # one GPU's slots / weights sit at 8 v / 16 v, aligned on any base the
    # wrapper passes)
    k = np.arange(geo.pairs)
    assert ((2 * k[2 * k + 1 < v_count]) * 2 * 4 % 16 == 0).all()


@pytest.mark.parametrize("u,v,block,rows", [(48, 48, (32, 8), 1), (2048, 2048, (256, 1), 8),
                                            (2047, 2049, (256, 1), 8), (512, 512, (256, 1), 1),
                                            (1, 5, (32, 8), 1), (4096, 3, (32, 8), 1),
                                            (1 << 20, 3, (32, 8), 8)])
def test_migration_cost_block_and_rows_per_thread(u, v, block, rows):
    """A narrow output gets a block of several 32-pair rows; a thread takes
    8 rows only from 2^21 cells on."""
    geo = mc.launch_geometry(u, v)
    assert (geo.block, geo.rows) == (block, rows)


def test_migration_cost_loops_row_tiles_past_the_grid_limit():
    u_count = 8 * 8 * (GRID_Y_LIMIT + 5) - 3  # 8 rows a thread, 8 row-threads a block
    geo = mc.launch_geometry(u_count, 3)
    assert (geo.block, geo.rows) == ((32, 8), 8)
    assert geo.grid == (1, GRID_Y_LIMIT)
    assert sorted(_tiles_of(geo)) == list(range(geo.row_tiles))
    tile = geo.block[1] * geo.rows
    assert geo.row_tiles * tile >= u_count > (geo.row_tiles - 1) * tile


def test_migration_cost_geometry_rejects_empty_and_aligns_views():
    with pytest.raises(ValueError, match="U, V >= 1"):
        mc.launch_geometry(0, 3)
    base = torch.arange(12, dtype=torch.int32)
    view = base[1:9].view(4, 2)  # contiguous, 4 bytes past the base
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    fixed = mc._aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    assert mc._aligned(base) is base


# --------------------------------------------------------------------------- #
# lap_bid: rows read in float4 chunks by a group of lanes
# --------------------------------------------------------------------------- #
def _lane_chunks(lane, group, chunks):
    """Chunks in the order lane ``lane`` reads them, as ``csrc/lap_bid.cu``
    loops: the unrolled steps of ``UNROLL`` chunks, then the remainder."""
    out, c = [], lane
    while c + (UNROLL - 1) * group < chunks:
        out += [c + u * group for u in range(UNROLL)]
        c += UNROLL * group
    while c < chunks:
        out.append(c)
        c += group
    return out


def _row_reads(start, m, group):
    """{lane: [(column, vector)]} for one row: the head to lane 0, chunks
    by :func:`_lane_chunks`, the tail to the last lane."""
    head, chunks, tail = row_split(start, m)
    reads = {lane: [] for lane in range(group)}
    reads[0] += [(j, False) for j in range(head)]
    for lane in range(group):
        reads[lane] += [(head + 4 * c, True) for c in _lane_chunks(lane, group, chunks)]
    reads[group - 1] += [(j, False) for j in range(head + 4 * chunks, m)]
    return reads


@pytest.mark.parametrize("m", [1, 3, 4, 5, 8, 9, 600, 4097])
@pytest.mark.parametrize("b,n", [(1, 1), (3, 5), (2, 9)])
def test_lap_bid_covers_every_row_and_column_once(b, n, m):
    geo = lb.launch_geometry(b, n, m)
    rows = b * n
    assert geo.group & (geo.group - 1) == 0 and geo.group <= lb.MAX_GROUP
    assert geo.rows_per_cta * geo.group == geo.threads == lb.THREADS
    assert geo.grid * geo.rows_per_cta >= rows > (geo.grid - 1) * geo.rows_per_cta
    # one group of lanes per row
    t = np.arange(geo.grid * geo.threads)
    owner = (t // geo.threads) * geo.rows_per_cta + (t % geo.threads) // geo.group
    owned = owner[owner < rows]
    assert np.array_equal(np.bincount(owned, minlength=rows), np.full(rows, geo.group))
    for a_base in range(4):  # the matrix's first element, in f32 past a 16-byte boundary
        for p_base in (0, 3):
            for row in range(rows):
                start = (a_base + row * m) % 4
                p_start = (p_base + (row // n) * m) % 4
                head = row_split(start, m)[0]
                p_vec = (p_start + head) % 4 == 0
                hits = np.zeros(m, np.int64)
                for lane, reads in _row_reads(start, m, geo.group).items():
                    for j, vec in reads:
                        hits[j:j + (4 if vec else 1)] += 1
                        if vec:
                            assert (start + j) % 4 == 0, (row, lane, j)
                            assert not p_vec or (p_start + j) % 4 == 0
                assert (hits == 1).all(), (a_base, row)


@pytest.mark.parametrize(
    "m,group", [(1, 1), (4, 1), (8, 1), (16, 1), (17, 2), (33, 4), (128, 8), (129, 16),
                (512, 32), (600, 32), (4096, 32)],
)
def test_lap_bid_lanes_per_row(m, group):
    """One thread owns a row up to 16 columns (the 4x4 / 8x8 pair LAPs); a
    warp owns a row of 512 columns and more; between, each lane keeps at
    least four float4 chunks' worth of columns."""
    assert lb.launch_geometry(1, 3, m).group == group


@pytest.mark.parametrize("b,n,m", [(262144, 4, 4), (1, 512, 512), (1, 4096, 4096), (4, 8, 600),
                                   ((1 << 26) + 1, 4, 4), (3, 1 << 20, 7)])
def test_lap_bid_grid_inside_the_old_launch_limit(b, n, m):
    """The grid never exceeds what the wrapper launched before the redesign
    (``next_pow2(m)`` lanes, at most 32, per row; 256 threads), so no batch
    that launched then raises now."""
    geo = lb.launch_geometry(b, n, m)
    old_group = min(32, 1 << max(0, math.ceil(math.log2(m))))
    assert geo.grid <= -(-(b * n * old_group) // 256) <= GRID_X_LIMIT


@pytest.mark.parametrize("n", [2, 3, 4, 5, 7, 8, 9, 511, 512, 513, 4096, 4097, 65535,
                               (1 << 20) + 3, (1 << 30) + 1, (1 << 31) - 1])
def test_lap_bid_row_divisor_is_exact_below_2_to_31(n):
    """A row's instance is a multiply and a shift: exact for every row the
    kernel computes it for (fewer than 2^31 rows), at each multiple of n and
    its neighbours and at random rows."""
    mul, shr = lb.row_divisor(n)
    assert 0 < mul < 1 << 32 and shr >= 0
    rng = np.random.default_rng(n)
    rows = [0, 1, n - 1, n, n + 1, (1 << 31) - 1] + rng.integers(0, 1 << 31, 2000).tolist()
    for k in (1, 2, 3, ((1 << 31) - 1) // n):
        rows += [k * n + d for d in (-1, 0, 1) if 0 <= k * n + d < 1 << 31]
    for row in rows:
        assert ((row * mul) >> 32) >> shr == row // n, row
    geo = lb.launch_geometry(1, n, 4)
    assert (geo.div_mul, geo.div_shr) == (mul, shr)
    assert lb.row_divisor(1) == (0, 0)


def test_lap_bid_geometry_rejects_empty():
    with pytest.raises(ValueError, match="m >= 1"):
        lb.launch_geometry(1, 4, 0)


def _push(state, v, j):
    """The kernel's ``push``: a strict compare, a lane's columns arriving in
    ascending order."""
    best, arg, second = state
    if v > best:
        return v, j, max(second, best)
    return best, arg, max(second, v)


def _merge(x, y):
    other = y[0] > x[0] or (y[0] == x[0] and y[1] < x[1])
    loser = x[0] if other else y[0]
    best, arg = (y[0], y[1]) if other else (x[0], x[1])
    return best, arg, max(loser, max(x[2], y[2]))


def _emulate_row(vals, start, group):
    """The kernel's scan over one row: each lane's (best, arg, second) in
    the order it reads its columns, then the butterfly merge across lanes."""
    lanes = []
    for reads in _row_reads(start, len(vals), group).values():
        state, last = (-np.inf, np.iinfo(np.int32).max, -np.inf), -1
        for j, vec in reads:
            for e in range(4 if vec else 1):
                assert j + e > last  # the strict compare needs ascending columns
                last = j + e
                state = _push(state, float(vals[j + e]), j + e)
        lanes.append(state)
    off = group // 2
    while off:
        lanes = [_merge(lanes[i], lanes[i ^ off]) for i in range(group)]
        off //= 2
    best, arg, second = lanes[0]
    return best, arg, max(second, lb.NEG_INF)


@pytest.mark.parametrize("m", [1, 3, 4, 5, 8, 9, 600, 4097])
@pytest.mark.parametrize("start", [0, 1, 2, 3])
def test_lap_bid_lane_split_keeps_the_first_argmax(m, start):
    """Ties on both sides of the scalar head, of a 16-byte chunk boundary, of
    a lane's stride and of an unrolled step: the split, the strict compare
    within a lane and the (v, j) rule across lanes give
    the plain version's first argmax and second value."""
    rng = np.random.default_rng(m * 4 + start)
    rows = rng.integers(-6, 3, size=(24, m)).astype(np.float32)
    head = row_split(start, m)[0]
    edges = [head - 1, head, head + 3, head + 4, head + 4 * 32 - 1, head + 4 * 32,
             head + 4 * 32 * UNROLL - 1, m - 1]
    for r, j in enumerate(e for e in edges if 0 <= e < m):
        rows[r, :] = -9.0
        rows[r, [j, min(j + 1, m - 1)]] = 7.0
    rows[-1, :] = 1.0  # every column tied
    group = lb.launch_geometry(1, 1, m).group
    plain = lb.lap_bid_top2_plain(torch.from_numpy(rows)[None], torch.zeros(1, m))
    for r in range(rows.shape[0]):
        best, arg, second = _emulate_row(rows[r], start, group)
        assert (best, arg, np.float32(second)) == (
            float(plain[0][0, r]), int(plain[1][0, r]), plain[2][0, r].numpy()), r
