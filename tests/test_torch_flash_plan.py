"""Launch plans of the attention kernels K6 and K7, on the CPU.

Everything the wrappers compute in Python before a launch — the instance
chosen by dtype and head dim, tiles and grid, shared memory, the bf16 K6
instance's TMA tensor maps, K7's split-K grid and ring depth — is held here
on a host without a card, and against the constants of the CUDA sources
(which check the plan's shared-memory size again at launch).  The kernels
themselves are held against their plain versions in ``test_torch_cuda.py``.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd

CSRC = Path(fa.__file__).resolve().parent / "csrc"
LIMIT = 232_448  # shared memory one block may use on an H100


# --------------------------------------------------------------------------- #
# K6 flash_attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("dtype,instance", [(torch.bfloat16, "tc_bf16"), (torch.float32, "cc_f32")])
def test_k6_instance_follows_dtype(dtype, instance, d):
    plan = fa.launch_plan((2, 300, 8, d), 2, dtype)
    assert plan["instance"] == instance
    assert (plan["maps"] is not None) == (dtype == torch.bfloat16)


def test_k6_plan_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.launch_plan((1, 64, 2, 64), 1, torch.float16)


@pytest.mark.parametrize(
    "shape,kv", [((1, 8192, 32, 128), 8), ((2, 63, 4, 64), 4), ((2, 129, 8, 128), 1), ((3, 4113, 16, 64), 2)]
)
def test_k6_tiles_and_grid(shape, kv):
    """One work item per (b * h, 128-query tile) in both instances (the tile
    sizes are held to the sources below).  The bf16 grid is what its launch
    runs, a persistent 1-D grid of min(items, SMs) CTAs of three
    warpgroups, two consumers and the producer; the f32 grid is a block an
    item, (b * h, query tiles), of eight warps."""
    b, s, h, _ = shape
    items = b * h * -(-s // 128)
    tc, cc = fa.launch_plan(shape, kv, torch.bfloat16), fa.launch_plan(shape, kv, torch.float32)
    assert tc["items"] == cc["items"] == items
    assert tc["grid"] == (min(items, fa.H100_SMS),) and tc["threads"] == 384 == 3 * 128
    assert fa.launch_plan(shape, kv, torch.bfloat16, sms=4)["grid"] == (min(items, 4),)
    assert cc["grid"] == (b * h, -(-s // 128)) and cc["threads"] == 256 == 8 * 32


@pytest.mark.parametrize("d,dynamic", [(64, 115_776), (80, 230_464), (128, 230_464), (192, 197_696)])
def test_k6_shared_memory_fits(d, dynamic):
    """Q + three K/V stages + alignment slack + eight mbarriers (Q full and
    empty, a full and an empty one per stage), under the
    227 KB a block may use, at the padded row width (D = 80 is laid out as
    128, the D = 128 instance's bytes) and the instance's keys per K/V tile
    (64 at D = 192: 128-key stages would take 345,152 bytes); the f32
    instance takes its own (``test_k6_f32_plan``)."""
    tc = fa.launch_plan((1, 256, 2, d), 1, torch.bfloat16)
    dp, bk = fa.tc_padded_dim(d), fa.tc_block_k(d)
    assert tc["dynamic_smem_bytes"] == dynamic == 1024 + 2 * 128 * dp + 3 * 2 * 2 * bk * dp + 8 * 8
    assert tc["dynamic_smem_bytes"] <= LIMIT
    assert fa.launch_plan((1, 256, 2, d), 1, torch.float32)["dynamic_smem_bytes"] == fa.cc_smem_bytes(d)


@pytest.mark.parametrize("d,tpr,bk,smem", [(64, 16, 64, 133_120), (80, 16, 64, 157_696),
                                           (128, 16, 64, 231_424), (192, 8, 32, 214_016)])
def test_k6_f32_plan(d, tpr, bk, smem):
    """The f32 instance: 256 threads a block, a block per (b * h, 128-query
    tile), ``tpr`` lanes a row and 4 * tpr keys a K/V tile; its shared
    memory (Q, two K stages with rows padded by a float4, two V stages,
    eight warps' P) under the 227 KB a block may use (D = 128 is the
    largest: 1,024 bytes to spare)."""
    plan = fa.launch_plan((2, 1000, 8, d), 2, torch.float32)
    assert plan["instance"] == "cc_f32" and plan["threads"] == fa.CC_THREADS == 256
    assert plan["grid"] == (16, 8) and plan["items"] == 128
    assert plan["threads_per_row"] == fa.cc_threads_per_row(d) == tpr
    assert plan["block_k"] == fa.cc_block_k(d) == bk == 4 * tpr
    assert plan["dynamic_smem_bytes"] == fa.cc_smem_bytes(d) == smem <= LIMIT
    assert smem == 4 * (128 * d + 2 * bk * (d + 4) + 2 * bk * d + 8 * bk * 16)


@pytest.mark.parametrize("s,launches", [(8192, True), (65535 * 128, True), (65535 * 128 + 1, False)])
def test_k6_one_launch_follows_each_instance(s, launches):
    """The f32 grid puts query tiles on its y dimension (at most 65,535);
    the bf16 grid is one CTA an SM whatever S is, and only its walk's int
    item index bounds it, so S past 65,535 tiles still takes one launch."""
    cc = fa.launch_plan((1, s, 1, 64), 1, torch.float32)
    tc = fa.launch_plan((1, s, 1, 64), 1, torch.bfloat16)
    assert fa.fits_one_launch(cc) == launches
    assert fa.fits_one_launch(tc) and tc["grid"] == (min(tc["items"], fa.H100_SMS),)
    assert not fa.fits_one_launch(dict(tc, items=fa.INT_MAX + 1))


def _cc_lanes(d):
    """The f32 instance's ownership, mirrored from ``cc::flash_attention_ffma``:
    for each lane (warp, row group g, lane t of the group) its rows of the
    128-query tile, its keys of a K/V tile and its columns of O."""
    tpr = fa.cc_threads_per_row(d)
    rgw, nc = 32 // tpr, d // (4 * tpr)
    rg = 16 // rgw
    lanes = []
    for warp in range(8):
        for lane in range(32):
            g, t = divmod(lane, tpr)
            rows = [16 * warp + rgw * r + g for r in range(rg)]
            keys = [t + tpr * i for i in range(4)]
            cols = [4 * (t + tpr * c) + e for c in range(nc) for e in range(4)]
            cols += list(range(4 * tpr * nc + t, d, tpr))
            lanes.append(dict(warp=warp, g=g, t=t, rows=rows, keys=keys, cols=cols))
    return lanes


def _wavefronts(addrs):
    """128-byte shared-memory wavefronts one warp's 16-byte accesses take:
    distinct float4 addresses (16-byte units) per bank group of 4 banks,
    the most in any group (the same address is a broadcast)."""
    per = {}
    for a in set(addrs):
        per.setdefault(a % 8, set()).add(a)
    return max(len(v) for v in per.values())


@pytest.mark.parametrize("d", [64, 80, 128, 192])
def test_k6_f32_micro_tiles_cover_the_tile_once(d):
    """Every (row, key) of a 128 x BK tile of S and every (row, column) of
    the 128 x D tile of O belongs to one lane; a lane's S and O rows are the
    same rows, all in its own warp (P goes through the warp's own buffer);
    a lane holds an RG x 4 micro-tile of S and RG x D / TPR of O."""
    bk, tpr = fa.cc_block_k(d), fa.cc_threads_per_row(d)
    s_own, o_own = {}, {}
    for ln in _cc_lanes(d):
        assert all(16 * ln["warp"] <= r < 16 * ln["warp"] + 16 for r in ln["rows"])
        assert len(ln["rows"]) * len(ln["keys"]) == 128 * bk // 256
        assert len(ln["cols"]) == d // tpr
        for r in ln["rows"]:
            for j in ln["keys"]:
                assert s_own.setdefault((r, j), ln) is ln
            for c in ln["cols"]:
                assert o_own.setdefault((r, c), ln) is ln
    assert len(s_own) == 128 * bk and len(o_own) == 128 * d


@pytest.mark.parametrize("d", [64, 80, 128, 192])
def test_k6_f32_shared_memory_reads_meet_no_bank_conflict(d):
    """Every warp-wide 16-byte access of the f32 instance takes the fewest
    wavefronts its distinct addresses need: Q's rows (float4 chunk c of row
    r at c ^ (r % RGW)), K's padded rows (D + 4 floats), V's rows, and the
    warp's P (float4 q of key j at q ^ ((j >> 1) & 3)), written and read.
    Also: at least 8 FFMAs a shared-memory load in both products."""
    bk, tpr = fa.cc_block_k(d), fa.cc_threads_per_row(d)
    rgw = 32 // tpr
    rg = 16 // rgw
    lanes = [ln for ln in _cc_lanes(d) if ln["warp"] == 3]
    ks, ch = (d + 4) // 4, d // 4  # float4s a K row, a Q or V row
    assert ks % 2 == 1

    def p_addr(j, quad):
        return j * 4 + (quad ^ ((j >> 1) & 3))

    for c in range(ch):
        for r in range(rg):
            q = [ln["rows"][r] * ch + (c ^ (ln["rows"][r] % rgw)) for ln in lanes]
            assert _wavefronts(q) == 1
            assert {ln["rows"][r] % rgw for ln in lanes} == set(range(rgw))
        for i in range(4):
            k = [ln["keys"][i] * ks + c for ln in lanes]
            assert _wavefronts(k) == -(-len(set(k)) // 8) == tpr // 8
    for j in range(bk):
        for quad in range(rg // 4):
            reads = [p_addr(j, ln["g"] * (rg // 4) + quad) for ln in lanes]
            assert _wavefronts(reads) == 1
        for c in range(d // (4 * tpr)):
            v = [j * ch + ln["t"] + tpr * c for ln in lanes]
            assert _wavefronts(v) == tpr // 8
    for i in range(4):
        for quad in range(rg // 4):
            writes = [p_addr(ln["keys"][i], ln["g"] * (rg // 4) + quad) for ln in lanes]
            assert len(set(writes)) == 32 and _wavefronts(writes) == 4
    # FFMAs a shared-memory load: Q K^T, per 4 columns (RG Q and 4 K float4s);
    # P V, per key (P's RG / 4 float4s, V's float4s and, at D 80, one float)
    nc, nr = d // (4 * tpr), (d % (4 * tpr)) // tpr
    assert 16 * rg / (rg + 4) >= 8
    assert rg * (4 * nc + nr) / (rg // 4 + nc + nr) >= 8


@pytest.mark.parametrize("d,dp", [(64, 64), (80, 128), (128, 128), (192, 192)])
def test_k6_padded_width_is_whole_panels(d, dp):
    assert fa.tc_padded_dim(d) == dp and dp % fa.TC_PANEL == 0


def test_k6_tensor_maps_at_head_dim_80_keep_the_real_width():
    """zamba2's shared block: the maps' innermost dim is the real 80 (TMA
    zero-fills the second 64-wide box past it), the box stays one 128-byte
    swizzled row, and the strides are those of the 160-byte rows."""
    plan = fa.launch_plan((1, 8192, 32, 80), 32, torch.bfloat16)
    for name in ("q", "k", "v"):
        assert plan["maps"][name] == dict(
            dims=(80, 32, 8192, 1), strides=(160, 32 * 160, 8192 * 32 * 160), box=(64, 1, 128, 1)
        )
    assert -(-80 // plan["maps"]["q"]["box"][0]) == fa.tc_padded_dim(80) // fa.TC_PANEL == 2


@pytest.mark.parametrize("d", [64, 80, 128])
def test_k6_plans_up_to_a_128_wide_row_keep_128_key_tiles(d):
    """The D 64/80/128 instances: 128-key K/V tiles, so their maps' boxes
    and items are those from before D = 192 came (16 x 8, under one CTA an
    SM); their consumer warpgroups take turns."""
    plan = fa.launch_plan((2, 1000, 8, d), 2, torch.bfloat16)
    assert fa.tc_block_k(d) == fa.TC_BLOCK_K == plan["block_k"] == 128 and plan["turns"]
    assert plan["items"] == 16 * 8 and plan["grid"] == (128,)
    for name in ("q", "k", "v"):
        assert plan["maps"][name]["box"] == (64, 1, 128, 1)
    assert plan["dynamic_smem_bytes"] == {64: 115_776, 80: 230_464, 128: 230_464}[d]


def test_k6_plan_at_head_dim_192():
    """nemotron-4's (1, 8192, 96 / 8 heads, 192): three whole 64-wide panels,
    no padding; 128-row query tiles (the q map's box) and 64-key K/V tiles
    (the k/v maps' boxes); 197,696 bytes of shared memory, under the limit;
    6,144 work items (head, query tile), walked by one CTA an SM.  The f32
    instance: a block an item, 8 lanes a row and 32-key tiles."""
    plan = fa.launch_plan((1, 8192, 96, 192), 8, torch.bfloat16)
    assert fa.tc_padded_dim(192) == 192 and fa.tc_block_k(192) == fa.TC_BLOCK_K_WIDE == 64
    assert plan["instance"] == "tc_bf16" and plan["block_k"] == 64 and not plan["turns"]
    assert plan["items"] == 96 * 64 and plan["grid"] == (132,)
    assert plan["dynamic_smem_bytes"] == 1024 + 49_152 + 3 * 2 * 24_576 + 64 == 197_696 <= LIMIT
    assert plan["maps"]["q"] == dict(dims=(192, 96, 8192, 1), strides=(384, 96 * 384, 8192 * 96 * 384),
                                     box=(64, 1, 128, 1))
    for name in ("k", "v"):
        assert plan["maps"][name] == dict(dims=(192, 8, 8192, 1), strides=(384, 8 * 384, 8192 * 8 * 384),
                                          box=(64, 1, 64, 1))
    arg = list(fa._maps_arg(plan["maps"]))
    assert (arg[9], arg[20], arg[31]) == (128, 64, 64)  # the box rows the C entry checks
    f32 = fa.launch_plan((1, 8192, 96, 192), 8, torch.float32)
    assert f32["instance"] == "cc_f32" and f32["grid"] == (96, 64) and f32["items"] == 96 * 64
    assert f32["block_k"] == 32 and f32["threads_per_row"] == 8
    assert f32["dynamic_smem_bytes"] == 214_016 <= LIMIT


def test_k6_tensor_maps_of_contiguous_operands():
    plan = fa.launch_plan((1, 8192, 32, 128), 8, torch.bfloat16)
    assert plan["maps"]["q"] == dict(
        dims=(128, 32, 8192, 1), strides=(256, 32 * 256, 8192 * 32 * 256), box=(64, 1, 128, 1)
    )
    for name in ("k", "v"):
        assert plan["maps"][name] == dict(
            dims=(128, 8, 8192, 1), strides=(256, 8 * 256, 8192 * 8 * 256), box=(64, 1, 128, 1)
        )


@pytest.mark.parametrize("d", [64, 80, 128, 192])
def test_k6_tensor_maps_of_fused_qkv_views(d):
    """q/k/v as views of one (B, S, H + 2 KV, D) projection: every map walks
    the fused row (S stride (H + 2 KV) D), each from its own base pointer."""
    b, s, h, kv = 2, 257, 8, 2
    x = torch.empty((b, s, h + 2 * kv, d), dtype=torch.bfloat16)
    q, k, v = x[:, :, :h], x[:, :, h:h + kv], x[:, :, h + kv:]
    plan = fa.launch_plan(q.shape, kv, torch.bfloat16, q.stride(), k.stride(), v.stride())
    row = (h + 2 * kv) * d * 2
    bk = fa.tc_block_k(d)
    assert plan["maps"]["q"] == dict(dims=(d, h, s, b), strides=(2 * d, row, s * row), box=(64, 1, 128, 1))
    assert plan["maps"]["k"] == dict(dims=(d, kv, s, b), strides=(2 * d, row, s * row), box=(64, 1, bk, 1))
    assert plan["maps"]["v"] == plan["maps"]["k"]
    for t in (q, k, v):
        assert fa._tma_view(t) is t  # aligned views are read in place


def test_k6_tensor_map_gives_size_one_dims_their_contiguous_stride():
    """TMA wants every stride a non-zero multiple of 16 bytes; a dim of size
    1 may carry any stride (here 1 element and 0), and its stride is unused."""
    m = fa.tensor_map((1, 100, 1, 64), (1, 64, 0, 1), 128)
    assert m == dict(dims=(64, 1, 100, 1), strides=(128, 128, 100 * 128), box=(64, 1, 128, 1))


@pytest.mark.parametrize("shape", [(2, 5, 3, 64), (1, 130, 4, 128), (3, 1, 2, 64), (2, 5, 3, 80),
                                   (1, 130, 32, 80), (2, 130, 12, 192)])
def test_k6_tensor_map_strides_are_tma_legal(shape):
    x = torch.empty(shape, dtype=torch.bfloat16)
    for view in (x, x[:, :, :1], x.transpose(1, 2).contiguous().transpose(1, 2)):
        m = fa.tensor_map(view.shape, view.stride(), 128)
        assert all(st > 0 and st % 16 == 0 and st < 2**40 for st in m["strides"])
        assert m["box"][0] * 2 == 128  # one 128-byte swizzled row


def test_k6_tma_view_copies_broadcast_operands():
    k = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16).expand(2, 64, 1, 64)
    assert k.stride()[0] == 0
    assert fa._tma_view(k).is_contiguous()


def test_k6_register_budget_fits_the_launch_grant():
    """``__launch_bounds__(384, 1)`` grants 168 registers a thread (65,536
    over 384, rounded down to the allocation unit of 8); after
    ``setmaxnreg`` the producer warpgroup holds 24 and the two consumer
    warpgroups 240 each, exactly the grant, and every count is a multiple of
    8 in [24, 256] as ``setmaxnreg`` wants."""
    grant = 65_536 // fa.TC_THREADS // 8 * 8
    assert grant == 168
    assert fa.TC_PRODUCER_REGS * 128 + fa.TC_CONSUMER_REGS * (fa.TC_THREADS - 128) == grant * fa.TC_THREADS
    for n in (fa.TC_PRODUCER_REGS, fa.TC_CONSUMER_REGS):
        assert n % 8 == 0 and 24 <= n <= 256
    # the fragments a consumer holds at once, over 128 threads: O (64 x D)
    # and S(t+1) (64 x block_k) in f32, P(t) (64 x block_k) and Q (64 x D)
    # in bf16
    for d, live in ((64, 144), (80, 156), (128, 192), (192, 192)):
        bk = fa.tc_block_k(d)
        assert d // 2 + bk // 2 + bk // 4 + d // 4 == live < fa.TC_CONSUMER_REGS


@pytest.mark.parametrize("items,ctas", [(1, 1), (4, 132), (132, 132), (133, 132), (2048, 132), (8192, 132),
                                         (6144, 132), (1000, 7)])
def test_k6_persistent_walk_takes_every_item_once(items, ctas):
    """The persistent grid (min(items, SMs) CTAs) covers every work item
    once, each CTA in increasing order, one a round."""
    walks = fa.tc_walk(items, min(items, ctas))
    assert sorted(i for w in walks for i in w) == list(range(items))
    assert all(w == sorted(w) and len(w) >= 1 for w in walks)
    assert max(map(len, walks)) - min(map(len, walks)) <= 1


@pytest.mark.parametrize("shape,kv", [((1, 8192, 32, 128), 8), ((1, 8192, 48, 128), 8), ((1, 8192, 96, 192), 8),
                                      ((1, 8192, 16, 64), 16), ((1, 32768, 32, 128), 8)])
def test_k6_persistent_walk_evens_causal_work(shape, kv):
    """The phase-2 rows, causal, items heaviest first on 132 CTAs: walking
    back and forth, every CTA's K/V tiles are within 0.5 % of the mean (a
    plain stride, CTA c taking c, c + 132, ..., would leave the heaviest
    1.6-13 % over it)."""
    b, s, h, d = shape
    plan = fa.launch_plan(shape, kv, torch.bfloat16)
    bh, qt = b * h, -(-s // 128)
    bk = plan["block_k"]
    assert plan["items"] == bh * qt and plan["grid"] == (132,)

    def tiles(i):  # a causal query tile's key tiles
        return (qt - 1 - i // bh + 1) * 128 // bk

    work = [sum(map(tiles, w)) for w in fa.tc_walk(plan["items"], plan["grid"][0])]
    mean = sum(work) / len(work)
    assert max(work) <= 1.005 * mean


def test_k6_maps_argument_layout():
    plan = fa.launch_plan((1, 300, 4, 64), 2, torch.bfloat16)
    arg = fa._maps_arg(plan["maps"])
    assert len(arg) == 33
    assert list(arg)[:11] == [64, 4, 300, 1, 128, 512, 300 * 512, 64, 1, 128, 1]


def _k6_emulated(q, k, v, causal):
    """The bf16 instance's arithmetic in its order, with the plain version's
    operations, on the CPU: per 128-row query tile and per K/V tile of
    ``tc_block_k(D)`` keys, S in f32 from bf16 products, masked from indices
    on the last tiles only; the online softmax in log2 units (l sums P in
    f32); S(t) formed and its softmax run before O, which holds P(t-1) V(t-1)
    by then, is rescaled for tile t; P rounded to bf16 for P V; O times
    1 / max(l, 1e-30) rounded to bf16."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    bk = fa.tc_block_k(d)
    scale = math.log2(math.e) / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (x.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1) for x in (k, v))
    out = torch.empty((b, h, s, d))
    for q0 in range(0, s, fa.TC_BLOCK_Q):
        rows = torch.arange(q0, min(q0 + fa.TC_BLOCK_Q, s))
        ntiles = -(-(min(q0 + fa.TC_BLOCK_Q, s) if causal else s) // bk)
        first_masked = ntiles - (fa.TC_BLOCK_Q // bk if causal else 1)
        m = torch.full((b, h, len(rows)), -math.inf)
        l = torch.zeros((b, h, len(rows)))
        o = torch.zeros((b, h, len(rows), d))

        def softmax(t):
            nonlocal m, l
            keys = torch.arange(t * bk, min(t * bk + bk, s))
            sc = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            if t >= first_masked and causal:
                sc = sc.masked_fill(keys[None, :] > rows[:, None], -math.inf)
            mx = torch.maximum(m, sc.amax(-1))
            sub = torch.where(mx == -math.inf, 0.0, mx * scale)
            alpha = torch.exp2(m * scale - sub)
            p = torch.exp2(sc * scale - sub[..., None])
            l, m = l * alpha + p.sum(-1), mx
            return p, alpha, keys

        p, _, keys = softmax(0)
        for t in range(1, ntiles):
            p_next, alpha, keys_next = softmax(t)  # S(t) before O's rescale for tile t
            o = (o + p.to(torch.bfloat16).float() @ vf[:, :, keys]) * alpha[..., None]
            p, keys = p_next, keys_next
        o = o + p.to(torch.bfloat16).float() @ vf[:, :, keys]
        out[:, :, rows] = o * (1 / l.clamp_min(1e-30))[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("g", [1, 5, 6, 12])
@pytest.mark.parametrize("d", [64, 80, 128, 192])
def test_k6_pipelined_numerics_hold_the_smoke_gate(d, g):
    """The redesigned order (S(t+1) issued under softmax(t), O rescaled
    after P(t) V(t) retires, P in bf16) over 300 queries (three query tiles,
    the last ragged) at group g: within 3e-2 of ``flash_attention_plain``
    and, per 128-row query tile, 1e-2 relative L2 error (the gate the
    card's smoke holds the kernel to), causal and not."""
    b, kv, s = 1, 2, 300
    rng = np.random.default_rng(d + g)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(torch.bfloat16)
               for sh in ((b, s, g * kv, d), (b, s, kv, d), (b, s, kv, d)))
    for causal in (True, False):
        got = _k6_emulated(q, k, v, causal).float()
        want = fa.flash_attention_plain(q, k, v, causal).float()
        torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
        d2 = (got - want).square().reshape(b, s, -1).sum(-1)
        w2 = want.square().reshape(b, s, -1).sum(-1)
        tiles = [slice(i, i + 128) for i in range(0, s, 128)]
        rel = max(float((d2[:, t].sum(-1) / w2[:, t].sum(-1)).sqrt().max()) for t in tiles)
        assert rel <= 1e-2


# --------------------------------------------------------------------------- #
# K7 flash_decode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "d,stages,row_bytes,per_sm",
    [(64, 3, 128, 4), (80, 3, 176, 3), (128, 2, 256, 3), (192, 2, 384, 2)],
)
def test_k7_bf16_ring_depth_and_shared_memory(d, stages, row_bytes, per_sm):
    """bf16 takes the mma instance at every head dim: a ring of 3 64-slot
    K+V tiles at D 64 and 80, 2 at D 128 and 192, rows of 2 D bytes (176 at
    D 80, padded to 11 chunks); and the blocks an SM's 228 KB holds: 4 at D
    64, 3 at D 80 and 128, 2 at D 192."""
    plan = fd.launch_plan((8, 32, d), (8, 8192, 8, d), torch.bfloat16)
    assert plan["instance"] == "mma_bf16"
    assert fd.mma_stages(d) == stages and fd.mma_row_chunks(d) * 16 == row_bytes
    assert plan["smem_bytes"] == stages * 2 * 64 * row_bytes == fd.mma_smem(d) <= fd.SMEM_LIMIT
    assert plan["blocks_per_sm"] == per_sm == fd.mma_min_blocks(d)
    assert per_sm * (plan["smem_bytes"] + 1024) <= 228 * 1024 < (per_sm + 1) * (plan["smem_bytes"] + 1024)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 5, 6, 8, 12, 16])
def test_k7_heads_per_warp(g, d):
    """An mma warp scores every head of the group at every head dim, the M
    rows of its products."""
    plan = fd.launch_plan((2, 2 * g, d), (2, 512, 2, d), torch.bfloat16)
    assert plan["instance"] == "mma_bf16" and plan["heads_per_warp"] == g
    assert plan["part_floats"] == 2 * 2 * plan["splits"] * g * (d + 2)


def test_k7_plan_at_head_dim_192():
    """nemotron-4's decode (B 8, 96 / 8 heads, 8192 slots, D 192) on the
    tensor-core instance: a ring of 2 stages (98,304 bytes), every warp
    scoring all 12 heads of the group (one at group 1), 2 blocks an SM, so 4
    splits of 32 tiles, 256 blocks in one wave of 264; the f32 instance (32-slot tiles, a 2-stage ring of
    rows padded by a float4, Q and the warps' P at chunk size 12) under the
    limit too, 2 blocks an SM, its grid sized to them: 4 splits of 64
    tiles."""
    plan = fd.launch_plan((8, 96, 192), (8, 8192, 8, 192), torch.bfloat16)
    assert plan["instance"] == "mma_bf16" and fd.mma_stages(192) == 2
    assert plan["heads_per_warp"] == 12
    assert plan["smem_bytes"] == 2 * 2 * 64 * 192 * 2 == 98_304 <= fd.SMEM_LIMIT
    assert plan["blocks_per_sm"] == 2
    assert (plan["splits"], plan["tiles_per_split"], plan["blocks"]) == (4, 32, 256)
    assert (plan["splits"], plan["tiles_per_split"]) == fd.resident_splits(8 * 8, 8192, 2 * 132)
    assert plan["part_floats"] == 8 * 8 * 4 * 12 * 194
    assert fd.launch_plan((2, 4, 192), (2, 512, 4, 192), torch.bfloat16)["heads_per_warp"] == 1
    f32 = fd.launch_plan((8, 96, 192), (8, 8192, 8, 192), torch.float32)
    g = 12
    assert f32["instance"] == "ffma_f32" and f32["heads_per_warp"] == g and f32["tile"] == 32
    assert f32["smem_bytes"] == 2 * 2 * 32 * 49 * 16 + 4 * g * 192 + 4 * 4 * 8 * g == 111_104
    assert f32["smem_bytes"] <= fd.SMEM_LIMIT and f32["blocks_per_sm"] == 2
    assert (f32["splits"], f32["tiles_per_split"], f32["blocks"]) == (4, 64, 256)
    assert 192 in fd.HEAD_DIMS


def test_k7_f32_instance_keeps_its_shared_memory():
    """f32 takes the FFMA instance at group 4: a 3-stage ring of 32-slot K
    and V tiles (rows of 33 float4s), Q (4 x 128) and each warp's P (8 x 4)."""
    plan = fd.launch_plan((2, 8, 128), (2, 512, 2, 128), torch.float32)
    assert plan["instance"] == "ffma_f32" and plan["heads_per_warp"] == 4
    g = 4
    assert plan["smem_bytes"] == 3 * 2 * 32 * 33 * 16 + 4 * g * 128 + 4 * 4 * 8 * g == 103_936 <= LIMIT


@pytest.mark.parametrize(
    "b,s,kv,want",
    [(8, 8192, 8, (8, 16)), (32, 32768, 8, (2, 256)), (1, 8192, 2, (128, 1)), (2, 64, 2, (1, 1)),
     (1, 100, 1, (2, 1)), (600, 4096, 1, (1, 64))],
)
def test_k7_split_k_grid(b, s, kv, want):
    """The split-K grid at D 64 is sized to the 4 x 132 blocks the card
    holds (``resident_splits``, as at every D) and covers every tile once: a
    serving cache, decode_32k's, batch 1, a single tile, and a batch large
    enough for one split."""
    plan = fd.launch_plan((b, 4 * kv, 64), (b, s, kv, 64), torch.bfloat16)
    assert plan["instance"] == "mma_bf16" and plan["blocks_per_sm"] == 4
    assert (plan["splits"], plan["tiles_per_split"]) == want == fd.resident_splits(b * kv, s, 4 * 132)
    assert plan["blocks"] <= 4 * 132 or plan["splits"] == 1
    tiles = -(-s // 64)
    assert plan["splits"] * plan["tiles_per_split"] >= tiles > (plan["splits"] - 1) * plan["tiles_per_split"]


@pytest.mark.parametrize("d", [64, 192])
def test_k7_launch_refuses_a_group_without_an_instance(d):
    """More than 16 query heads per KV head has no bf16 instance (the 16 M
    rows of an m16n8k16); the wrapper raises before it touches a card."""
    q = torch.zeros((1, 17, d), dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 1, d), dtype=torch.bfloat16)
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    with pytest.raises(ValueError, match="17 query heads per KV head"):
        fd._launch(q, k, k, 64, plan)


# --------------------------------------------------------------------------- #
# K7's tensor-core instance: row layout, warp slices, residency
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_k7_mma_swizzle_is_a_permutation_of_the_tile(d):
    """Every (row, chunk) of a 64-row tile of d/8 16-byte chunks has its own
    16-byte slot, inside the tile, and a row's chunks stay in that row; at
    D 64, 128 and 192 the map is a permutation of the tile's 2 d-byte rows
    (a swizzle)."""
    chunks, row = d // 8, fd.mma_row_chunks(d) * 16
    offsets = [fd.mma_chunk_offset(r, c, d) for r in range(64) for c in range(chunks)]
    assert all(o % 16 == 0 for o in offsets)
    assert len(set(offsets)) == len(offsets) and max(offsets) < 64 * row
    if row == 2 * d:
        assert sorted(o // 16 for o in offsets) == list(range(64 * chunks))
    for r in range(64):
        assert {fd.mma_chunk_offset(r, c, d) // row for c in range(chunks)} == {r}


@pytest.mark.parametrize("d", [64, 80])
def test_k7_mma_rows_at_d64_and_d80(d):
    """D 64's 128-byte rows take the XOR swizzle, whose chunk c ^ (r & 7)
    stays in the row's 8 chunks; D 80's 10 chunks would reach chunk 15 that
    way, so its rows are padded to 11 (176 bytes): the map is a bijection of
    each row's 10 chunks onto the first 10 of its 11, the pad unused, and
    the 8 rows of each ldmatrix (slots 8j .. 8j + 7 of a tile) at one chunk
    fall in 8 distinct 16-byte bank groups, where the unpadded 160-byte
    stride gives 4 (2-way conflicts)."""
    chunks = d // 8
    if d == 64:
        assert fd.mma_row_chunks(d) == 8 and max(c ^ 7 for c in range(chunks)) == 7
    else:
        assert fd.mma_row_chunks(d) == 11 and max(c ^ 7 for c in range(chunks)) == 15
    row = fd.mma_row_chunks(d) * 16
    for r in range(64):
        slots = sorted(fd.mma_chunk_offset(r, c, d) - r * row for c in range(chunks))
        assert slots == [16 * c for c in range(chunks)]
    for first in range(0, 64, 8):
        for c in range(chunks):
            rows = range(first, first + 8)
            assert len({(fd.mma_chunk_offset(r, c, d) % 128) // 16 for r in rows}) == 8
            assert len({(r * 2 * d + 16 * c) % 128 // 16 for r in rows}) == (1 if d == 64 else 4)


@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_k7_mma_ldmatrix_rows_take_distinct_bank_groups(d):
    """Any 8 consecutive rows (one ldmatrix matrix) at one logical chunk fall
    in 8 distinct 16-byte bank groups (of 8 in 128 bytes), at every chunk;
    at a stride of 2 d bytes they would share fewer (one for the 128-, 256-
    and 384-byte rows, 0 mod 128; four for D 80's 160)."""
    for first in range(64 - 7):
        for c in range(d // 8):
            rows = range(first, first + 8)
            assert len({(fd.mma_chunk_offset(r, c, d) % 128) // 16 for r in rows}) == 8
            assert len({(r * 2 * d + 16 * c) % 128 for r in rows}) < 8


def test_k7_mma_warps_own_16_slot_slices():
    assert fd.MMA_WARP_SLOTS == 16
    assert [fd.mma_warp_slots(w) for w in range(fd.WARPS)] == [range(16 * w, 16 * w + 16) for w in range(4)]


@pytest.mark.parametrize("d,resident", [(64, 528), (80, 396), (128, 396), (192, 264)])
@pytest.mark.parametrize(
    "b,s,kv", [(8, 32768, 8), (8, 8192, 8), (1, 32768, 8), (1, 100, 1), (2, 64, 2), (32, 32768, 8),
               (600, 4096, 1), (3, 1000, 5)]
)
def test_k7_mma_splits_cover_every_slot_once_within_one_wave(b, s, kv, d, resident):
    """Walking every split's tiles and every warp's slice of each covers
    every slot of the cache once; the grid is B * KV * splits blocks, within
    the blocks the card holds at once (4 an SM at D 64, 3 at D 80 and 128,
    2 at D 192) unless B * KV alone is more, and then one split per (b,
    kv)."""
    plan = fd.launch_plan((b, 4 * kv, d), (b, s, kv, d), torch.bfloat16)
    nsplit, per = plan["splits"], plan["tiles_per_split"]
    assert plan["blocks"] == b * kv * nsplit and plan["blocks_per_sm"] * 132 == resident
    assert (nsplit, per) == fd.resident_splits(b * kv, s, resident)
    tiles = -(-s // 64)
    seen = []
    for split in range(nsplit):
        for t in range(split * per, min(split * per + per, tiles)):
            for w in range(fd.WARPS):
                seen += [t * 64 + j for j in fd.mma_warp_slots(w)]
    assert sorted(seen) == list(range(tiles * 64))
    if b * kv <= resident:  # one wave, and a tile fewer per split would need more
        assert plan["blocks"] <= resident
        assert per == 1 or b * kv * -(-tiles // (per - 1)) > resident
    else:
        assert nsplit == 1


def test_k7_mma_residency_follows_shared_memory_and_registers():
    """Two 96 KB blocks (D 192) fit in an SM's 228 KB, three do not; three
    64 KB blocks (D 128) or 66 KB ones (D 80), not four; four 48 KB blocks
    (D 64), not five.  The launch bounds' budgets, 255, 168 and 128
    registers a thread, allow as many blocks of 128 threads, so registers
    never bind first; 169 or 129 would."""
    assert [fd.mma_registers(d) for d in fd.HEAD_DIMS] == [128, 168, 168, 255]
    assert fd.blocks_per_sm(98_304) == 2 and fd.blocks_per_sm(98_304, 255) == 2
    assert fd.blocks_per_sm(65_536) == 3 and fd.blocks_per_sm(65_536, 168) == 3
    assert fd.blocks_per_sm(65_536, 169) == 2  # registers bind
    assert fd.blocks_per_sm(67_584) == 3 and fd.blocks_per_sm(67_584, 168) == 3
    assert fd.blocks_per_sm(49_152) == 4 and fd.blocks_per_sm(49_152, 128) == 4
    assert fd.blocks_per_sm(49_152, 129) == 3  # registers bind
    plan = fd.launch_plan((8, 96, 192), (8, 32768, 8, 192), torch.bfloat16)
    assert (plan["splits"], plan["tiles_per_split"], plan["blocks"]) == (4, 128, 256)
    zamba = fd.launch_plan((8, 32, 80), (8, 32768, 32, 80), torch.bfloat16)  # (e5)'s whole cache
    assert (zamba["splits"], zamba["tiles_per_split"], zamba["blocks"]) == (1, 512, 256)
    seamless = fd.launch_plan((8, 16, 64), (8, 32768, 16, 64), torch.bfloat16)  # (e6)'s heads
    assert (seamless["splits"], seamless["tiles_per_split"], seamless["blocks"]) == (4, 128, 512)
    serve = fd.launch_plan((8, 32, 128), (8, 8192, 8, 128), torch.bfloat16)  # llama3-8b's cache
    assert (serve["instance"], serve["splits"], serve["tiles_per_split"], serve["blocks"]) == (
        "mma_bf16", 6, 22, 384)
    long = fd.launch_plan((32, 32, 128), (32, 32768, 8, 128), torch.bfloat16)  # decode_32k
    assert (long["splits"], long["tiles_per_split"], long["blocks"]) == (1, 512, 256)


def _mma_emulated(q, k, v, valid, splits, per):
    """The mma instance's arithmetic with the plain version's operations, on
    the CPU: per split, per 64-slot tile, each warp's 16 slots scored in f32
    from bf16 products, scaled by log2(e)/sqrt(D), masked; an online softmax
    per warp and head in log2 units with P rounded to bf16 (l sums the
    rounded P); acc += P V.  Then the four warps merged, the split's m in
    natural-log units, and the splits merged as the merge kernel does."""
    b, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, kv, g, d)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B, KV, S, D)
    scale = math.log2(math.e) / math.sqrt(d)
    tiles = -(-valid // 64)
    ms, ls, accs = [], [], []
    for split in range(splits):
        m = torch.full((b, kv, 4, g), -math.inf)
        l = torch.zeros((b, kv, 4, g))
        acc = torch.zeros((b, kv, 4, g, d))
        for t in range(split * per, min(split * per + per, tiles)):
            kt = kf[:, :, t * 64:(t + 1) * 64].reshape(b, kv, 4, 16, d)
            vt = vf[:, :, t * 64:(t + 1) * 64].reshape(b, kv, 4, 16, d)
            sc = torch.einsum("bkgd,bkwsd->bkwgs", qf, kt) * scale
            slot = t * 64 + torch.arange(64).reshape(4, 1, 16)
            sc = sc.masked_fill(slot >= valid, -math.inf)
            mx = torch.maximum(m, sc.amax(-1))
            sub = torch.where(mx == -math.inf, 0.0, mx)
            alpha = torch.exp2(m - sub)
            p = torch.exp2(sc - sub[..., None]).to(torch.bfloat16).float()
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkwgs,bkwsd->bkwgd", p, vt)
            m = mx
        mx = m.amax(2)
        sub = torch.where(mx == -math.inf, 0.0, mx)
        c = torch.exp2(m - sub[:, :, None])
        ms.append(torch.where(mx == -math.inf, -1e30, mx * math.log(2)))
        ls.append((l * c).sum(2))
        accs.append((acc * c[..., None]).sum(2))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0).clamp_min(-1e30))
    out = (acc * w[..., None]).sum(0) / (l * w).sum(0).clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


@pytest.mark.parametrize("d,g", [(192, 1), (192, 12), (128, 4), (128, 8), (80, 1), (64, 1)])
def test_k7_mma_numerics_hold_the_smoke_gate(d, g):
    """P rounded to bf16 per 16-slot warp chunk, then the four-warp and split
    merges, over 4096 valid slots (nemotron-4's D 192 at groups 1 and 12,
    D 128 at groups 4 and 8, zamba2's D 80 and seamless's D 64 at group 1):
    within 3e-2 of ``flash_decode_plain`` and, per head, 1e-2 relative L2
    error (the gate the card's smoke holds the kernel to)."""
    b, kv, s = 2, 2, 4096
    rng = np.random.default_rng(g)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(torch.bfloat16)
               for sh in ((b, g * kv, d), (b, s, kv, d), (b, s, kv, d)))
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    got = _mma_emulated(q, k, v, s, plan["splits"], plan["tiles_per_split"]).float()
    want = fd.flash_decode_plain(q, k, v, s).float()
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
    rel = ((got - want).square().sum(-1) / want.square().sum(-1)).sqrt()
    assert float(rel.max()) <= 1e-2
    # ragged: a last tile with some warps' slices past valid_len, some splits empty
    got = _mma_emulated(q, k, v, 1000, plan["splits"], plan["tiles_per_split"]).float()
    want = fd.flash_decode_plain(q, k, v, 1000).float()
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)


# --------------------------------------------------------------------------- #
# K7's f32 instance (ffma::): ring, residency, grid, warp slices, head chunks
# --------------------------------------------------------------------------- #
FFMA_GROUPS = [1, 4, 5, 6, 8, 12, 16, 32]


@pytest.mark.parametrize("g", FFMA_GROUPS)
@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_k7_ffma_shared_memory_is_the_sources(d, g):
    """The plan's shared memory is ``ffma::smem_bytes``: as many 32-slot K+V
    stages of (D / 4 + 1)-float4 rows as fit in ~110 KB (at most 4; two at
    least), Q at the chunk size and each warp's P (8 slots x chunk size);
    under the block limit, and the four warps' states fit in the ring."""
    plan = fd.launch_plan((2, 2 * g, d), (2, 1024, 2, d), torch.float32)
    gp = plan["heads_per_warp"]
    assert plan["instance"] == "ffma_f32" and gp == fd.ffma_head_class(g, d)
    stages = min(4, 110 * 1024 // (2 * 32 * (d // 4 + 1) * 16))
    assert stages == fd.ffma_stages(d) == {64: 4, 80: 4, 128: 3, 192: 2}[d] >= 2
    ring = stages * 2 * 32 * (d // 4 + 1) * 16
    assert plan["smem_bytes"] == ring + 4 * gp * d + 4 * 4 * 8 * gp == fd.ffma_smem(d, gp) <= fd.SMEM_LIMIT
    assert 4 * gp * (d + 2) * 4 <= ring
    assert 2 * 32 * d * 4 * (stages - 1) >= 32 * 1024  # the tiles in flight under a scored one


@pytest.mark.parametrize("g", FFMA_GROUPS)
@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_k7_ffma_blocks_per_sm_and_registers(d, g):
    """At least two blocks an SM at every D and chunk size (3 at D 64); the
    launch bounds' register budget (168 at D 64, 255 elsewhere) holds as
    many, so the shared memory binds first."""
    plan = fd.launch_plan((1, g, d), (1, 512, 1, d), torch.float32)
    per_sm, regs = plan["blocks_per_sm"], fd.ffma_registers(d)
    assert per_sm == fd.ffma_min_blocks(d) == (3 if d == 64 else 2) >= 2
    assert regs == (168 if d == 64 else 255)
    assert per_sm * (plan["smem_bytes"] + 1024) <= fd.SM_SMEM
    assert fd.blocks_per_sm(plan["smem_bytes"]) == per_sm  # the smaller chunks hold no more
    assert per_sm * 4 * -(-regs * 32 // 256) * 256 <= fd.SM_REGISTERS
    assert fd.blocks_per_sm(plan["smem_bytes"], regs) == per_sm


@pytest.mark.parametrize("g", FFMA_GROUPS)
@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_k7_ffma_grid_covers_every_slot_and_head_once(d, g):
    """For a serving cache, a whole 32768-slot cache, batch 1 and a ragged
    small one: walking every chunk's splits, their 32-slot tiles and each
    warp's 8 slots covers every (head, slot) of a KV head once; the grid is
    B * KV * chunks * splits blocks, within one wave of the blocks the card
    holds unless B * KV * chunks alone is more, and a tile fewer per split
    would need more."""
    for b, s, kv in ((8, 8192, 8), (8, 32768, 8), (1, 32768, 2), (3, 1000, 5)):
        plan = fd.launch_plan((b, g * kv, d), (b, s, kv, d), torch.float32)
        nsplit, per, chunks = plan["splits"], plan["tiles_per_split"], plan["chunks"]
        resident = plan["blocks_per_sm"] * fd.SMS
        assert (nsplit, per) == fd.resident_splits(b * kv * chunks, s, resident, 32)
        assert plan["blocks"] == b * kv * chunks * nsplit and plan["tile"] == 32
        tiles = -(-s // 32)
        seen = []
        for c0 in fd.ffma_head_chunks(g, d):
            heads = range(c0, min(g, c0 + fd.ffma_max_group(d)))
            for split in range(nsplit):
                for t in range(split * per, min(split * per + per, tiles)):
                    for w in range(fd.WARPS):
                        seen += [(h, t * 32 + j) for h in heads for j in fd.ffma_warp_slots(w)]
        assert sorted(seen) == [(h, j) for h in range(g) for j in range(tiles * 32)]
        if b * kv * chunks <= resident:
            assert plan["blocks"] <= resident
            assert per == 1 or b * kv * chunks * -(-tiles // (per - 1)) > resident
        else:
            assert nsplit == 1
        assert plan["part_floats"] == b * kv * nsplit * g * (d + 2)


@pytest.mark.parametrize("g", FFMA_GROUPS)
@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_k7_ffma_head_chunks(d, g):
    """Up to 16 heads (12 at D 192) a block serves the whole group on the
    least chunk size of 1/2/4/8/12/16 that holds it; past that, chunks on a
    grid axis, each reading its KV head's cache once (the cache read
    ceil(G / 16) times, ceil(G / 12) at D 192), the last one's rows past G
    zero."""
    plan = fd.launch_plan((2, 2 * g, d), (2, 4096, 2, d), torch.float32)
    most = fd.ffma_max_group(d)
    assert most == (12 if d == 192 else 16)
    chunks = list(fd.ffma_head_chunks(g, d))
    assert plan["chunks"] == len(chunks) == -(-g // most)
    assert chunks == list(range(0, g, most))
    sizes = [min(most, g - c0) for c0 in chunks]
    assert sum(sizes) == g and all(0 < n <= plan["heads_per_warp"] for n in sizes)
    gp = plan["heads_per_warp"]
    assert gp in fd.FFMA_HEAD_CLASSES and most >= gp >= min(g, most)
    assert all(c < min(g, most) for c in fd.FFMA_HEAD_CLASSES if c < gp)  # the least that holds it
    assert plan["heads_per_warp"] <= fd._MAX_HEADS_PER_WARP["ffma_f32"]


@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_k7_ffma_warp_slices_and_lanes_cover_a_tile(d):
    """The four warps' 8-slot slices cover a 32-slot tile exactly; within a
    warp, lane (sl, dl) = (lane & 7, lane >> 3) scores slot sl over float4
    chunks dl, dl + 4, ..., so the four lanes of a slot cover its row once;
    for P V, lane L holds O's float2 columns L, L + 32, ... (at D 80 lanes
    8-31 one), every column of the row once."""
    assert [s for w in range(fd.WARPS) for s in fd.ffma_warp_slots(w)] == list(range(32))
    chunks = d // 4
    for sl in range(8):
        covered = sorted(c for dl in range(4) for c in range(dl, chunks, 4))
        assert covered == list(range(chunks))
        assert all(len(range(dl, chunks, 4)) == chunks // 4 for dl in range(4))
    nv = -(-(d // 2) // 32)
    cols = sorted(lane + 32 * i for lane in range(32) for i in range(nv) if lane + 32 * i < d // 2)
    assert cols == list(range(d // 2))


@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_k7_ffma_shared_memory_reads_meet_no_bank_conflict(d):
    """Each quarter-warp's K float4 loads (8 slots at one chunk) take 8
    distinct 16-byte bank groups, as the odd row length of D / 4 + 1 float4s
    gives (unpadded, D 64/128/192 rows would share one); each half-warp's
    V float2 loads (one row, 16 consecutive columns) are 128 contiguous
    bytes; Q's float4s are one address a quarter-warp (a broadcast)."""
    r4 = fd.ffma_row4(d)
    assert r4 % 2 == 1
    for w in range(fd.WARPS):
        for c in range(d // 4):
            rows = [8 * w + sl for sl in range(8)]
            assert len({(fd.ffma_row_offset(r, c, d) % 128) // 16 for r in rows}) == 8
    if d != 80:
        assert len({(r * d * 4 + 16 * c) % 128 // 16 for r in range(8) for c in [0]}) < 8
    for j in range(32):
        for half in range(2):
            offs = [fd.ffma_row_offset(j, 0, d) + 8 * (16 * half + lane) for lane in range(16)]
            assert offs == list(range(offs[0], offs[0] + 128, 8))


def _ffma_emulated(q, k, v, valid, plan):
    """The f32 instance's arithmetic with the plain version's operations, on
    the CPU: per chunk of heads and split, per 32-slot tile, each warp's 8
    slots scored against log2(e)/sqrt(D)-scaled Q, masked, an online
    softmax per warp and head in log2 units (alpha, then exp2 of the scores
    less the new max); the four warps merged, the split's m in natural-log
    units, and the splits merged as the merge kernel does."""
    b, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qf = q.double().reshape(b, kv, g, d) * (math.log2(math.e) / math.sqrt(d))
    kf, vf = (x.double().permute(0, 2, 1, 3) for x in (k, v))  # (B, KV, S, D)
    tiles = -(-valid // 32)
    per = plan["tiles_per_split"]
    ms, ls, accs = [], [], []
    for split in range(plan["splits"]):
        m = torch.full((b, kv, 4, g), -math.inf, dtype=torch.float64)
        l = torch.zeros((b, kv, 4, g), dtype=torch.float64)
        acc = torch.zeros((b, kv, 4, g, d), dtype=torch.float64)
        for t in range(split * per, min(split * per + per, tiles)):
            kt = kf[:, :, t * 32:(t + 1) * 32].reshape(b, kv, 4, 8, d)
            vt = vf[:, :, t * 32:(t + 1) * 32].reshape(b, kv, 4, 8, d)
            sc = torch.einsum("bkgd,bkwsd->bkwgs", qf, kt)
            slot = t * 32 + torch.arange(32).reshape(4, 1, 8)
            sc = sc.masked_fill(slot >= valid, -math.inf)
            live = (t * 32 + 8 * torch.arange(4) < valid).reshape(4, 1)  # a warp with a valid slot
            mx = torch.where(live, torch.maximum(m, sc.amax(-1)), m)
            alpha = torch.where(live, torch.exp2(m - mx), 1.0)
            p = torch.exp2(sc - mx[..., None]).nan_to_num(0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkwgs,bkwsd->bkwgd", p, vt)
            m = mx
        mx = m.amax(2)
        sub = torch.where(mx == -math.inf, 0.0, mx)
        c = torch.exp2(m - sub[:, :, None])
        ms.append(torch.where(mx == -math.inf, -1e30, mx * math.log(2)))
        ls.append((l * c).sum(2))
        accs.append((acc * c[..., None]).sum(2))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0).clamp_min(-1e30))
    out = (acc * w[..., None]).sum(0) / (l * w).sum(0).clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).float()


@pytest.mark.parametrize("d,g", [(64, 1), (80, 1), (128, 4), (192, 12), (128, 32)])
def test_k7_ffma_numerics_hold_the_f32_gate(d, g):
    """The f32 instance's algorithm (per-warp online softmax over 8-slot
    slices of 32-slot tiles, the four-warp and split merges), emulated in
    f64, within 2e-5 of ``flash_decode_plain`` at 2000 valid slots and at a
    ragged 77 (a last tile with warps past valid_len, most splits empty)."""
    b, kv, s = 2, 2, 2048
    rng = np.random.default_rng(d + g)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               for sh in ((b, g * kv, d), (b, s, kv, d), (b, s, kv, d)))
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    for valid in (2000, 77):
        got = _ffma_emulated(q, k, v, valid, plan)
        torch.testing.assert_close(got, fd.flash_decode_plain(q, k, v, valid), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------- #
# the plans agree with the CUDA sources; the build reports what it built
# --------------------------------------------------------------------------- #
def _constant(src: str, name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m, name
    return m.group(1).strip()


def test_plans_match_the_cuda_sources():
    attn = (CSRC / "flash_attention.cu").read_text()
    tc = attn[attn.index("namespace tc {"):]
    assert _constant(tc, "BM") == str(fa.TC_BLOCK_Q)
    assert _constant(tc, "BN") == str(fa.TC_BLOCK_K)
    assert _constant(tc, "BN_WIDE") == str(fa.TC_BLOCK_K_WIDE)
    assert "block_k(int dp) { return dp > 128 ? BN_WIDE : BN; }" in tc
    assert _constant(tc, "STAGES") == str(fa.TC_STAGES)
    assert _constant(tc, "PANEL") == str(fa.TC_PANEL)
    assert "padded(int d) { return (d + PANEL - 1) / PANEL * PANEL; }" in tc
    assert "Smem<padded(D)>::BYTES" in tc
    # warp-specialised roles: two consumer warpgroups and the producer
    # warpgroup, registers handed over by setmaxnreg, turns by named barriers
    assert _constant(tc, "CONSUMERS") == "256" and _constant(tc, "THREADS") == "CONSUMERS + 128"
    assert 256 + 128 == fa.TC_THREADS
    assert _constant(tc, "PRODUCER_REGS") == str(fa.TC_PRODUCER_REGS)
    assert _constant(tc, "CONSUMER_REGS") == str(fa.TC_CONSUMER_REGS)
    assert "setmaxnreg_dec<PRODUCER_REGS>();" in tc and "setmaxnreg_inc<CONSUMER_REGS>();" in tc
    assert "__launch_bounds__(THREADS, 1)\nflash_attention_wgmma" in tc
    assert _constant(tc, "TURN_BAR") == str(fa.TC_TURN_BARRIERS[0])
    assert "my_turn = TURN_BAR + wg, their_turn = TURN_BAR + (wg ^ 1);" in tc
    assert fa.TC_TURN_BARRIERS == (1, 2)  # 0 is __syncthreads
    assert "takes_turns(int dp) { return dp <= 128; }" in tc and "constexpr bool TURNS = takes_turns(DP);" in tc
    assert [fa.tc_takes_turns(d) for d in fa.HEAD_DIMS] == [True, True, True, False]
    assert "static constexpr int BARRIERS = 8 * (2 + 2 * STAGES);" in tc
    assert 'bar.sync %0, %1;" ::"r"(bar), "n"(CONSUMERS)' in tc
    assert "wgmma_wait<1>();" in tc  # S(t) retires while P(t-1) V(t-1) runs
    assert "qa[D / 4];" in tc and "load_q<D>(qa, sq_wg, warp & 3, lane);" in tc  # Q in registers
    # the persistent walk (tc_walk) and the grid of min(items, SMs) CTAs
    assert "int item_of(int r, int c, int g) { return r * g + ((r & 1) ? g - 1 - c : c); }" in tc
    assert "<<<(unsigned)(items < sms ? items : sms), THREADS, BYTES, stream>>>" in tc
    assert "w.q0 = (QT - 1 - i / BH) * BM;" in tc  # heaviest query tiles first
    cc = attn[attn.index("namespace cc {"):attn.index("}  // namespace cc")]
    assert _constant(cc, "BQ") == str(fa.CC_BLOCK_Q)
    assert _constant(cc, "THREADS") == str(fa.CC_THREADS)
    assert _constant(cc, "P_ROW") == str(fa.CC_P_ROW)
    assert "threads_per_row(int d) { return d > 128 ? 8 : 16; }" in cc
    assert "block_k(int d) { return 4 * threads_per_row(d); }" in cc
    assert "static constexpr int KS = D + 4;" in cc
    assert "static constexpr int BYTES = 4 * (Q + 2 * K + 2 * V + P);" in cc
    assert "if (smem != BYTES) return cudaErrorInvalidValue;" in cc
    assert "const dim3 grid(B * H, (S + BQ - 1) / BQ);" in cc
    # the swizzles and ownership the layout tests mirror
    assert "sq + r * D + 4 * (c ^ (r % RGW))" in cc
    assert "4 * ((g * QUADS + qd) ^ ((j >> 1) & 3))" in cc
    assert "const int g = lane / TPR, t = lane % TPR;" in cc
    assert "vt + j * D + 4 * (t + TPR * c)" in cc
    # exact f32: FFMAs only, no tensor-core instruction, one barrier a tile
    assert "mma" not in cc and "tf32" not in cc.lower() and cc.count("__syncthreads()") == 1
    assert "ex2.approx.ftz.f32" in cc and "__frcp_rn(fmaxf(lt, 1e-30f))" in cc
    # the bf16 overloads of the old f32 kernel are gone (only float is instantiated)
    assert "bfloat16" not in cc and "load16" not in cc and "to_f32" not in cc
    for d in fa.HEAD_DIMS:
        assert f"cc::launch<{d}>(q, k, v, o, B, S, H, KV, causal, st, smem, s)" in attn
    dec = (CSRC / "flash_decode.cu").read_text()
    assert _constant(dec, "DBK") == str(fd.TILE)
    assert _constant(dec, "WARPS") == "THREADS / 32" and _constant(dec, "THREADS") == str(32 * fd.WARPS)
    assert _constant(dec, "SM_SMEM") == f"{fd.SM_SMEM}, BLOCK_RESERVED = {fd.BLOCK_SMEM_RESERVED}"
    # one bf16 instance, mma::, at every head dim: no route to another
    assert "on_mma" not in dec and "namespace ring" not in dec and "partial_ring" not in dec
    assert "} else {\n    // a warp scores every head of the group on the tensor cores" in dec
    for d in fd.HEAD_DIMS:
        assert f"case {d}: return (int)mma::blocks_per_sm<{d}>(blocks);" in dec
    mma = dec[dec.index("namespace mma {"):dec.index("}  // namespace mma")]
    assert _constant(mma, "WARP_SLOTS") == "DBK / WARPS" and fd.MMA_WARP_SLOTS == fd.TILE // fd.WARPS
    assert _constant(mma, "MAX_GROUP") == str(fd.MMA_MAX_GROUP)
    assert "return D > 80 ? 2 : 3;" in mma  # stages: mma_stages
    assert [fd.mma_stages(d) for d in fd.HEAD_DIMS] == [3, 3, 2, 2]
    assert "return D % 64 == 0 ? D / 8 : D / 8 + 1;" in mma  # row_chunks: mma_row_chunks
    assert [fd.mma_row_chunks(d) for d in fd.HEAD_DIMS] == [8, 11, 16, 24]
    assert "return stages<D>() * 2 * DBK * row_chunks<D>() * 16;" in mma  # mma_smem
    assert "return SM_SMEM / (smem_bytes<D>() + BLOCK_RESERVED);" in mma  # min_blocks: mma_min_blocks
    assert [fd.mma_min_blocks(d) for d in fd.HEAD_DIMS] == [4, 3, 3, 2]
    # mma_chunk_offset: the XOR swizzle where a row is 0 mod 128, else the padded row
    assert "if constexpr (D % 64 == 0) {\n    return r * (D * 2) + ((c ^ (r & 7)) << 4);" in mma
    assert "return (r * row_chunks<D>() + c) << 4;" in mma
    assert mma.count("chunk_offset<D>(") == 4  # the copy (K, V) and the reads (K, V)
    assert "__launch_bounds__(THREADS, min_blocks<D>())" in mma
    ff = dec[dec.index("namespace ffma {"):dec.index("}  // namespace ffma")]
    assert _constant(ff, "TS") == str(fd.FFMA_TILE)
    assert _constant(ff, "WARP_SLOTS") == "TS / WARPS" and fd.FFMA_WARP_SLOTS == fd.FFMA_TILE // fd.WARPS
    assert "int max_group(int d) { return d > 128 ? 12 : 16; }" in ff
    assert [fd.ffma_max_group(d) for d in fd.HEAD_DIMS] == [16, 16, 16, 12]
    assert _constant(ff, "RING_BYTES") == "110 * 1024" and _constant(ff, "MAX_STAGES") == "4"
    assert "int row4(int d) { return d / 4 + 1; }" in ff
    assert "return 2 * TS * row4(d) * 16; }" in ff
    assert "return stages(d) * stage_bytes(d) + 4 * gp * d + 4 * WARPS * WARP_SLOTS * gp;" in ff
    assert "return SM_SMEM / (smem_bytes(d, max_group(d)) + BLOCK_RESERVED);" in ff
    assert "__launch_bounds__(THREADS, min_blocks(D))" in ff
    assert "g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : g <= 8 ? 8 : g <= 12 ? 12 : 16;" in ff
    for c in fd.FFMA_HEAD_CLASSES:
        assert f"case {c}: return f(std::integral_constant<int, {c}>{{}});" in ff
    assert [fd.ffma_head_class(g, 128) for g in range(1, 17)] == [1, 2, 4, 4] + [8] * 4 + [12] * 4 + [16] * 4
    assert [fd.ffma_head_class(g, 192) for g in (12, 13, 16, 32)] == [12] * 4
    # the lane map and layouts the tests above mirror
    assert "const int sl = lane & 7, dl = lane >> 3;" in ff
    assert "const int c = dl + 4 * i;" in ff and "kt[sl * R4 + c]" in ff
    assert "const int c2 = lane + 32 * i;" in ff
    assert "dim3 grid(B * KV, nsplit, (G + max_group(D) - 1) / max_group(D));" in ff
    assert "const int g0 = blockIdx.z * max_group(D);" in ff
    # exact f32: FFMAs only, no tensor-core instruction; one barrier a tile
    # and two around the warps' merge
    assert "mma" not in ff and "tf32" not in ff.lower() and ff.count("__syncthreads()") == 3
    assert "bfloat16" not in ff
    assert "flash_decode_partial<" not in dec and "load16" not in dec


def test_ptxas_report_parses_registers_spills_and_shared_memory():
    log = (
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kv\n"
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 167 registers, used 1 barriers, 404 bytes cmem[0]\n"
        "ptxas info    : Function properties for _Z1gv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 221 registers, 32768 bytes smem, 440 bytes cmem[0]\n"
    )
    assert build.ptxas_report(log) == {
        "_Z1kv": dict(stack=8, spill_stores=8, spill_loads=4, registers=167, smem=0),
        "_Z1gv": dict(stack=0, spill_stores=0, spill_loads=0, registers=221, smem=32768),
    }
    assert "-v" in build.NVCC_FLAGS
