"""Launch plans of the attention kernels K6 and K7, on the CPU.

Everything the wrappers compute in Python before a launch — the instance
chosen by dtype and head dim, tiles and grid, shared memory, the bf16 K6
instance's TMA tensor maps, K7's split-K grid and ring depth — is held here
on a host without a card, and against the constants of the CUDA sources
(which check the plan's shared-memory size again at launch).  The kernels
themselves are held against their plain versions in ``test_torch_cuda.py``.
"""

import re
from pathlib import Path

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
    """One block per (b * h, query tile): 128 rows in bf16, 64 in f32 (the
    tile sizes are held to the sources below)."""
    b, s, h, _ = shape
    assert fa.launch_plan(shape, kv, torch.bfloat16)["grid"] == (b * h, -(-s // 128))
    assert fa.launch_plan(shape, kv, torch.float32)["grid"] == (b * h, -(-s // 64))


@pytest.mark.parametrize("d,dynamic", [(64, 115_768), (80, 230_456), (128, 230_456), (192, 197_688)])
def test_k6_shared_memory_fits(d, dynamic):
    """Q + three K/V stages + alignment slack + seven mbarriers, under the
    227 KB a block may use, at the padded row width (D = 80 is laid out as
    128, the D = 128 instance's bytes) and the instance's keys per K/V tile
    (64 at D = 192: 128-key stages would take 345,144 bytes); the f32
    instance has none dynamic."""
    tc = fa.launch_plan((1, 256, 2, d), 1, torch.bfloat16)
    dp, bk = fa.tc_padded_dim(d), fa.tc_block_k(d)
    assert tc["dynamic_smem_bytes"] == dynamic == 1024 + 2 * 128 * dp + 3 * 2 * 2 * bk * dp + 8 * 7
    assert tc["dynamic_smem_bytes"] <= LIMIT
    assert fa.launch_plan((1, 256, 2, d), 1, torch.float32)["dynamic_smem_bytes"] == 0


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
    """The D 64/80/128 instances as they were before D = 192 came: 128-key
    K/V tiles, so their maps' boxes, shared memory and grid are unchanged."""
    plan = fa.launch_plan((2, 1000, 8, d), 2, torch.bfloat16)
    assert fa.tc_block_k(d) == fa.TC_BLOCK_K == plan["block_k"] == 128
    assert plan["grid"] == (16, 8)
    for name in ("q", "k", "v"):
        assert plan["maps"][name]["box"] == (64, 1, 128, 1)
    assert plan["dynamic_smem_bytes"] == {64: 115_768, 80: 230_456, 128: 230_456}[d]


def test_k6_plan_at_head_dim_192():
    """nemotron-4's (1, 8192, 96 / 8 heads, 192): three whole 64-wide panels,
    no padding; 128-row query tiles (the q map's box) and 64-key K/V tiles
    (the k/v maps' boxes); 197,688 bytes of shared memory, under the limit;
    one CTA per (head, query tile)."""
    plan = fa.launch_plan((1, 8192, 96, 192), 8, torch.bfloat16)
    assert fa.tc_padded_dim(192) == 192 and fa.tc_block_k(192) == fa.TC_BLOCK_K_WIDE == 64
    assert plan["instance"] == "tc_bf16" and plan["block_k"] == 64
    assert plan["grid"] == (96, 64)
    assert plan["dynamic_smem_bytes"] == 1024 + 49_152 + 3 * 2 * 24_576 + 56 == 197_688 <= LIMIT
    assert plan["maps"]["q"] == dict(dims=(192, 96, 8192, 1), strides=(384, 96 * 384, 8192 * 96 * 384),
                                     box=(64, 1, 128, 1))
    for name in ("k", "v"):
        assert plan["maps"][name] == dict(dims=(192, 8, 8192, 1), strides=(384, 8 * 384, 8192 * 8 * 384),
                                          box=(64, 1, 64, 1))
    arg = list(fa._maps_arg(plan["maps"]))
    assert (arg[9], arg[20], arg[31]) == (128, 64, 64)  # the box rows the C entry checks
    f32 = fa.launch_plan((1, 8192, 96, 192), 8, torch.float32)
    assert f32["instance"] == "cc_f32" and f32["grid"] == (96, 128)


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


def test_k6_maps_argument_layout():
    plan = fa.launch_plan((1, 300, 4, 64), 2, torch.bfloat16)
    arg = fa._maps_arg(plan["maps"])
    assert len(arg) == 33
    assert list(arg)[:11] == [64, 4, 300, 1, 128, 512, 300 * 512, 64, 1, 128, 1]


# --------------------------------------------------------------------------- #
# K7 flash_decode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d,stages", [(64, 4), (80, 4), (128, 3), (192, 2)])
def test_k7_bf16_ring_depth_and_shared_memory(d, stages):
    """As many 64-slot K+V tiles as fit in ~110 KB (two blocks per SM), at
    most four."""
    plan = fd.launch_plan((8, 32, d), (8, 8192, 8, d), torch.bfloat16)
    assert plan["instance"] == "ring_bf16"
    assert fd.ring_stages(d) == stages
    assert plan["smem_bytes"] == stages * 2 * 64 * d * 2 <= 110 * 1024
    assert 2 * plan["smem_bytes"] <= 228 * 1024


@pytest.mark.parametrize("g,hpw", [(1, 1), (4, 1), (5, 2), (6, 2), (8, 2), (12, 3), (16, 4)])
def test_k7_heads_per_warp(g, hpw):
    plan = fd.launch_plan((2, 2 * g, 128), (2, 512, 2, 128), torch.bfloat16)
    assert plan["heads_per_warp"] == hpw
    assert plan["part_floats"] == 2 * 2 * plan["splits"] * g * 130


def test_k7_plan_at_head_dim_192():
    """nemotron-4's decode (B 8, 96 / 8 heads, 8192 slots, D 192): a ring of
    2 stages (98,304 bytes), three heads a warp at group 12 (one at group
    1), the f32 instance's shared memory under the limit too."""
    plan = fd.launch_plan((8, 96, 192), (8, 8192, 8, 192), torch.bfloat16)
    assert plan["instance"] == "ring_bf16" and fd.ring_stages(192) == 2
    assert plan["heads_per_warp"] == 3
    assert plan["smem_bytes"] == 2 * 2 * 64 * 192 * 2 == 98_304 <= fd.SMEM_LIMIT
    assert (plan["splits"], plan["tiles_per_split"]) == (9, 15)
    assert plan["part_floats"] == 8 * 8 * 9 * 12 * 194
    assert fd.launch_plan((2, 4, 192), (2, 512, 4, 192), torch.bfloat16)["heads_per_warp"] == 1
    f32 = fd.launch_plan((8, 96, 192), (8, 8192, 8, 192), torch.float32)
    g = 12
    assert f32["smem_bytes"] == 4 * (64 * 193 + 64 * 192 + 2 * g * 192 + g * 64 + 3 * g) == 120_208
    assert f32["smem_bytes"] <= fd.SMEM_LIMIT
    assert 192 in fd.HEAD_DIMS


def test_k7_f32_instance_keeps_its_shared_memory():
    plan = fd.launch_plan((2, 8, 128), (2, 512, 2, 128), torch.float32)
    assert plan["instance"] == "cc_f32" and plan["heads_per_warp"] == 0
    g = 4
    assert plan["smem_bytes"] == 4 * (64 * 129 + 64 * 128 + 2 * g * 128 + g * 64 + 3 * g) <= LIMIT


@pytest.mark.parametrize(
    "b,s,kv,want",
    [(8, 8192, 8, (9, 15)), (32, 32768, 8, (3, 171)), (1, 8192, 2, (128, 1)), (2, 64, 2, (1, 1)),
     (1, 100, 1, (2, 1)), (600, 4096, 1, (1, 64))],
)
def test_k7_split_k_grid(b, s, kv, want):
    """Splits cover every tile once: the serving path's shape, decode_32k,
    batch 1, a single tile, and a batch large enough for one split."""
    plan = fd.launch_plan((b, 4 * kv, 128), (b, s, kv, 128), torch.bfloat16)
    assert (plan["splits"], plan["tiles_per_split"]) == want
    tiles = -(-s // 64)
    assert plan["splits"] * plan["tiles_per_split"] >= tiles > (plan["splits"] - 1) * plan["tiles_per_split"]


def test_k7_launch_refuses_a_group_without_an_instance():
    """More than 16 query heads per KV head has no bf16 instance (four warps
    of at most four heads); the wrapper raises before it touches a card."""
    q = torch.zeros((1, 17, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16)
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    with pytest.raises(ValueError, match="17 query heads per KV head"):
        fd._launch(q, k, k, 64, plan)


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
    cc = attn[attn.index("namespace cc {"):attn.index("namespace tc {")]
    assert _constant(cc, "BQ") == str(fa.CC_BLOCK_Q)
    dec = (CSRC / "flash_decode.cu").read_text()
    assert _constant(dec, "DBK") == str(fd.TILE)
    assert _constant(dec, "WARPS") == "THREADS / 32" and _constant(dec, "THREADS") == str(32 * fd.WARPS)
    assert "(110 * 1024) / (2 * DBK * D * 2) < 4" in dec and fd._RING_BYTES == 110 * 1024


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
