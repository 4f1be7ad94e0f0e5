"""The port's launch layer without the dry-run (``launch/{mesh,pspec,specs}``)
and ``roofline`` against the JAX package, on the CPU.

The counterparts of the reference's ``test_launch_roofline.py``
``TestShardingRules``, ``TestInputSpecs`` and ``TestCollectiveParser`` on
the port, then differential cases: every (arch, shape)'s input specs, and
for every reduced config the port's params and serving cache against the
same leaves of the reference's ``jax.eval_shape`` trees — paths, shapes,
logical axes, the specs with a 16-way axis size patched in as the
reference's tests do, and the bytes per device on the single-pod mesh.
"""

import types

import jax
import pytest
import torch

from repro import roofline as jax_roofline
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.launch import mesh as jax_mesh
from repro.launch import pspec as jax_pspec
from repro.launch import specs as jax_specs
from repro.models import get_model as jax_get_model
from repro_torch import roofline
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.launch.mesh import Mesh, dp_axes_of, make_production_mesh, make_smoke_mesh
from repro_torch.launch.pspec import NamedSharding, ShardingRules, constrain, current_rules, use_rules
from repro_torch.launch.specs import (
    INPUT_SHAPES,
    batch_logical_axes,
    bytes_per_device,
    cache_logical_axes,
    input_specs,
    logical_axes_for,
    sharding_tree,
    tree_paths_and_leaves,
)
from repro_torch.models import get_model
from repro_torch.roofline import bytes_of_type, parse_collectives
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)


def _sixteen_way(rules):
    """The reference tests' 16-way axis (``axis_size`` patched on a 1x1
    mesh)."""
    rules.axis_size = lambda phys: 16 if phys else 1
    return rules


# --------------------------------------------------------------------------- #
# the mesh
# --------------------------------------------------------------------------- #
def test_production_meshes_are_the_reference_layout():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model") and single.shape == {"data": 16, "model": 16}
    assert list(multi.shape.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert dp_axes_of(single) == ("data",) and dp_axes_of(multi) == ("pod", "data")
    smoke = make_smoke_mesh()
    assert smoke.shape == {"data": 1, "model": 1}
    assert dp_axes_of(smoke) == jax_mesh.dp_axes_of(jax_mesh.make_smoke_mesh()) == ("data",)
    assert dict(jax_mesh.make_smoke_mesh().shape) == smoke.shape


def test_mesh_is_a_frozen_description():
    mesh = make_production_mesh()
    with pytest.raises(Exception):
        mesh.axis_sizes = (1, 1)
    with pytest.raises(ValueError):
        Mesh(("data", "model"), (16,))
    assert hash(mesh) == hash(make_production_mesh())


# --------------------------------------------------------------------------- #
# the sharding rules (TestShardingRules)
# --------------------------------------------------------------------------- #
def test_divisibility_fallback():
    rules = _sixteen_way(ShardingRules(make_smoke_mesh()))
    spec = rules.spec_for((12, 128), ("heads", "ff"))
    assert spec[0] is None  # 12 heads don't divide 16
    assert spec[1] == "model"


def test_duplicate_mesh_axis_suppressed():
    rules = _sixteen_way(ShardingRules(make_smoke_mesh(), {"seq": "model"}))
    spec = rules.spec_for((256, 4096, 32, 128), ("batch", "seq", "heads", None))
    assert spec[1] == "model"  # seq takes "model"; heads must NOT also get it
    assert spec[2] is None


def test_constrain_noop_outside_context():
    x = torch.ones((4, 4))
    assert current_rules() is None and constrain(x, "batch", None) is x


def test_constrain_rank_mismatch():
    with use_rules(ShardingRules(make_smoke_mesh())):
        with pytest.raises(ValueError):
            constrain(torch.ones((4, 4)), "batch")


def test_constrain_inside_a_context_returns_its_input_and_the_context_unwinds():
    rules = ShardingRules(make_production_mesh())
    x = torch.ones((4, 4))
    with use_rules(rules) as r:
        assert r is rules and current_rules() is rules
        assert constrain(x, "batch", None) is x
        with use_rules(None):
            assert current_rules() is None
        assert current_rules() is rules
    assert current_rules() is None


@pytest.mark.parametrize("multi_pod", [False, True])
def test_specs_on_the_production_mesh(multi_pod):
    """No patch: the mesh description's own sizes (16-way model, 16- or
    32-way data parallel)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = ShardingRules(mesh, dp_axes=dp_axes_of(mesh))
    dp = ("pod", "data") if multi_pod else "data"
    assert rules.spec_for((256, 4096, 4096), ("batch", "seq", "embed")) == (dp, None, None)
    assert rules.spec_for((16, 4096), ("batch", None)) == ((None, None) if multi_pod else ("data", None))
    assert rules.axis_size(dp) == (32 if multi_pod else 16)
    sh = rules.sharding_for((4096, 32, 128), ("fsdp", "heads", None))
    assert sh == NamedSharding(mesh, (dp, "model", None))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("logical", [("batch", "seq", "heads", None), ("fsdp", "heads", None),
                                     ("heads_flat", "fsdp"), ("expert", "fsdp", None),
                                     ("capacity", "expert", None), ("vocab", "fsdp")])
@pytest.mark.parametrize("sizes", [(256, 4096, 32, 128), (12, 96, 8960, 7), (64, 16, 2, 3)])
def test_spec_for_equals_jax(multi_pod, logical, sizes):
    """The same dims and logical axes give the reference's spec, with the
    reference tests' 16-way patch on both sides and the pod axis in the
    data-parallel axes when asked."""
    dp = ("pod", "data") if multi_pod else ("data",)
    ours = _sixteen_way(ShardingRules(make_smoke_mesh(), dp_axes=dp))
    ref = _sixteen_way(jax_pspec.ShardingRules(jax_mesh.make_smoke_mesh(), dp_axes=dp))
    sizes = sizes[:len(logical)]
    assert ours.spec_for(sizes, logical) == tuple(ref.spec_for(sizes, logical))


# --------------------------------------------------------------------------- #
# input specs (TestInputSpecs)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_specs_exist_are_abstract_and_equal_jax(arch, shape_name):
    cfg, shp = get_config(arch), INPUT_SHAPES[shape_name]
    specs = input_specs(cfg, shp)
    assert "tokens" in specs
    for v in specs.values():
        assert isinstance(v, torch.Tensor) and v.is_meta
    if shp.kind == "decode":
        assert specs["tokens"].shape == (shp.global_batch, 1)
    else:
        assert specs["tokens"].shape == (shp.global_batch, shp.seq_len)
    if cfg.frontend == "vision" and shp.kind != "decode":
        assert "image_embeds" in specs
    if cfg.frontend == "audio" and shp.kind != "decode":
        assert "audio_frames" in specs
    want = jax_specs.input_specs(jax_get_config(arch), jax_specs.INPUT_SHAPES[shape_name])
    assert set(specs) == set(want)
    for k, v in specs.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[1] == str(want[k].dtype), k
        assert batch_logical_axes(k, v.ndim) == jax_specs.batch_logical_axes(k, v.ndim)


def test_input_shapes_equal_jax():
    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in INPUT_SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind) for k, s in jax_specs.INPUT_SHAPES.items()}


# --------------------------------------------------------------------------- #
# logical axes and bytes per device
# --------------------------------------------------------------------------- #
def test_param_logical_axes_patterns():
    assert logical_axes_for("embed", (1000, 64)) == ("vocab", "fsdp")
    assert logical_axes_for("layers.attn.wq", (4, 64, 8, 16)) == (None, "fsdp", "heads", None)
    assert logical_axes_for("layers.moe.w_gate", (4, 8, 64, 128)) == (None, "expert", "fsdp", None)
    # shared experts are dense ffn, not expert-parallel
    assert logical_axes_for("layers.moe.shared.w_gate", (4, 64, 128)) == (None, "fsdp", "ff")
    assert logical_axes_for("layers.norm1", (4, 64)) == (None, None)
    assert logical_axes_for("layers.mamba.in_proj", (4, 64, 300)) == (None, "fsdp", "ssm_inner")
    # the encoder-decoder's stacks
    assert logical_axes_for("enc_layers.attn.wk", (12, 1024, 16, 64)) == (None, "fsdp", "kv_heads", None)
    assert logical_axes_for("dec_layers.cross_attn.wo", (12, 1024, 1024)) == (None, "heads_flat", "fsdp")
    assert logical_axes_for("dec_layers.norm_x", (12, 1024)) == (None, None)
    assert cache_logical_axes("cross_k", (12, 8, 512, 16, 64)) == (None, "batch", None, "kv_heads", None)


def test_bytes_per_device_unsharded():
    rules = ShardingRules(make_smoke_mesh())
    tree = {"a": torch.empty((8, 8), dtype=torch.float32, device="meta")}
    sh = sharding_tree(tree, rules, lambda p, s: (None, None))
    assert bytes_per_device(tree, sh) == 8 * 8 * 4


def test_a_layer_list_is_one_stacked_leaf():
    """Three per-layer dicts read as the reference's stacked leaves, paths as
    ``train/checkpoint.py`` writes them; a sharded bf16 leaf's bytes."""
    layer = lambda: {"attn": {"wq": torch.zeros((64, 32, 8), dtype=torch.bfloat16)},  # noqa: E731
                     "norm1": torch.zeros((64,))}
    tree = {"layers": [layer() for _ in range(3)], "embed": torch.zeros((512, 64))}
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_paths_and_leaves(tree)}
    assert got == {"embed": ((512, 64), torch.float32),
                   "layers.attn.wq": ((3, 64, 32, 8), torch.bfloat16),
                   "layers.norm1": ((3, 64), torch.float32)}
    mesh = make_production_mesh()
    sh = sharding_tree(tree, ShardingRules(mesh), logical_axes_for)
    assert sh["layers.attn.wq"] == NamedSharding(mesh, (None, "data", "model", None))
    assert bytes_per_device(tree, sh) == (3 * 64 * 32 * 8 * 2 // 256 + 3 * 64 * 4
                                          + 512 * 64 * 4 // 256)


def _jax_paths(tree):
    return dict(jax_specs.tree_paths_and_leaves(tree))


def _fake_jax_sharding(rules, path, leaf, axes_fn):
    """What the reference's ``bytes_per_device`` reads of a sharding (its
    ``mesh.shape`` and ``spec``), from the reference's rules on the
    single-pod mesh's sizes."""
    spec = rules.spec_for(leaf.shape, axes_fn(path, leaf.shape))
    return types.SimpleNamespace(mesh=types.SimpleNamespace(shape={"data": 16, "model": 16}),
                                 spec=spec)


def _held_to_jax(ours, want, axes_fn):
    """The same paths and shapes, the same logical axes, the same specs
    with the 16-way patch and the same bytes per device on the single-pod
    mesh as the reference's tree ``want`` (ShapeDtypeStructs)."""
    jaxes_fn = {logical_axes_for: jax_specs.logical_axes_for,
                cache_logical_axes: jax_specs.cache_logical_axes}[axes_fn]
    mine = dict(tree_paths_and_leaves(ours))
    theirs = _jax_paths(want)
    assert set(mine) == set(theirs)
    rules = _sixteen_way(ShardingRules(make_smoke_mesh()))
    jrules = _sixteen_way(jax_pspec.ShardingRules(jax_mesh.make_smoke_mesh()))
    for path, leaf in mine.items():
        shape = tuple(leaf.shape)
        assert shape == tuple(theirs[path].shape), path
        assert str(leaf.dtype).split(".")[1] == str(theirs[path].dtype), path
        axes, jaxes = axes_fn(path, shape), jaxes_fn(path, shape)
        assert axes == jaxes, path
        assert rules.spec_for(shape, axes) == tuple(jrules.spec_for(shape, jaxes)), path
    jsh = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(want),
        [_fake_jax_sharding(jrules, p, leaf, jaxes_fn) for p, leaf in jax_specs.tree_paths_and_leaves(want)])
    prod = ShardingRules(make_production_mesh())
    assert bytes_per_device(ours, sharding_tree(ours, prod, axes_fn)) == \
        jax_specs.bytes_per_device(want, jsh)


@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_specs_and_bytes_equal_jax(arch):
    cfg, jcfg = get_reduced(arch), jax_get_reduced(arch)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    want = jax.eval_shape(lambda k: jax_get_model(jcfg).init(k, jcfg), jax.random.PRNGKey(0))
    _held_to_jax(params, want, logical_axes_for)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_axes_specs_and_bytes_equal_jax(arch):
    cfg, jcfg = get_reduced(arch), jax_get_reduced(arch)
    cache = get_model(cfg).init_cache(cfg, 2, 32, "cpu")
    want = jax.eval_shape(lambda: jax_get_model(jcfg).init_cache(jcfg, 2, 32))
    _held_to_jax(cache, want, cache_logical_axes)


# --------------------------------------------------------------------------- #
# the collective parser (TestCollectiveParser) and the report
# --------------------------------------------------------------------------- #
HLO = """
HloModule jit_step

fused_computation {
  %p0 = f32[128,256]{1,0} parameter(0)
  ROOT %add.1 = f32[128,256]{1,0} add(%p0, %p0)
}

ENTRY main {
  %arg0 = f32[128,256]{1,0} parameter(0)
  %arg1 = bf16[64,64]{1,0} parameter(1)
  %all-gather.1 = f32[2048,256]{1,0} all-gather(%arg0), replica_groups={}, dimensions={0}
  %all-reduce.2 = f32[128,256]{1,0} all-reduce(%arg0), to_apply=%fused_computation
  %ar-start = f32[128,256]{1,0} all-reduce-start(%arg0), to_apply=%fused_computation
  %ar-done = f32[128,256]{1,0} all-reduce-done(%ar-start)
  %cp = bf16[64,64]{1,0} collective-permute(%arg1), source_target_pairs={{0,1}}
  ROOT %t = (f32[2048,256]{1,0}) tuple(%all-gather.1)
}
"""

#: more of HLO's spellings: tuple-typed all-to-all and reduce-scatter, a
#: -start with no operand known (the result's size), pred and s8 types
HLO_MORE = """
ENTRY main {
  %x = s8[1024]{0} parameter(0)
  %y = (f32[16,4], bf16[8]) parameter(1)
  %a2a = (f32[16,4], bf16[8]) all-to-all(%y), dimensions={0}
  %rs = f32[2,4]{1,0} reduce-scatter(%x), dimensions={0}, to_apply=%add
  %ag-start = pred[77]{0} all-gather-start(%unknown), dimensions={0}
  %ag-done = pred[77]{0} all-gather-done(%ag-start)
  ROOT %out = s8[1024]{0} copy(%x)
}
"""


def test_bytes_of_type():
    assert bytes_of_type("f32[128,256]{1,0}") == 128 * 256 * 4
    assert bytes_of_type("bf16[64,64]") == 64 * 64 * 2
    assert bytes_of_type("(f32[8], bf16[4])") == 8 * 4 + 4 * 2
    assert bytes_of_type("pred[]") == 1


def test_parse_collectives():
    stats = parse_collectives(HLO)
    assert stats.by_kind["all-gather"][0] == 1
    assert stats.by_kind["all-gather"][1] == 128 * 256 * 4  # operand size
    # all-reduce counted twice (plain + -start), -done skipped
    assert stats.by_kind["all-reduce"][0] == 2
    assert stats.by_kind["collective-permute"] == (1, 64 * 64 * 2)


@pytest.mark.parametrize("text", [HLO, HLO_MORE])
def test_parse_collectives_equals_jax(text):
    ours, want = parse_collectives(text), jax_roofline.parse_collectives(text)
    assert ours.by_kind == want.by_kind
    assert (ours.total_bytes, ours.total_count) == (want.total_bytes, want.total_count)
    for t in ("f32[128,256]{1,0}", "(f32[16,4], bf16[8])", "s8[1024]", "c128[3]", "token[]"):
        assert bytes_of_type(t) == jax_roofline.bytes_of_type(t)


def test_the_constants_are_the_h100s_and_no_tpu_figure_remains():
    ours = (roofline.PEAK_FLOPS, roofline.PEAK_F32_FLOPS, roofline.PEAK_F64_FLOPS,
            roofline.HBM_BW, roofline.NVLINK_BW)
    assert ours == (989e12, 67e12, 34e12, 3.35e12, 450e9)
    ref = {jax_roofline.PEAK_FLOPS, jax_roofline.HBM_BW, jax_roofline.ICI_BW}
    assert not ref & set(ours)
    assert not hasattr(roofline, "ICI_BW")


def test_the_chip_smokes_bounds_take_the_roofline_constants():
    """The card's peaks live in one module: the smoke's bounds read them."""
    import chip_smoke

    assert (chip_smoke.PEAK_BF16_OPS_PER_S, chip_smoke.PEAK_F32_OPS_PER_S,
            chip_smoke.PEAK_F64_OPS_PER_S, chip_smoke.PEAK_BYTES_PER_S) == (
        roofline.PEAK_FLOPS, roofline.PEAK_F32_FLOPS, roofline.PEAK_F64_FLOPS, roofline.HBM_BW)


@pytest.mark.parametrize("flops,nbytes,coll", [(1e15, 1e9, 1e6), (1e9, 1e12, 1e6), (1e9, 1e9, 1e12)])
def test_report_terms_on_the_h100_constants(flops, nbytes, coll):
    """The same report as the reference's but for the constants: each term
    is the count over the H100's rate, the bottleneck the largest term,
    the model-FLOPs ratio and the dict's keys the reference's."""
    kw = dict(arch="llama3-8b", shape="train_4k", mesh="16x16", chips=256,
              hlo_flops_per_device=flops, hlo_bytes_per_device=nbytes,
              collective_bytes_per_device=coll, collective_counts={"all-reduce": (2, 10)},
              model_flops_total=roofline.model_flops(8_000_000_000, 256 * 4096, "train"),
              peak_memory_per_device=None)
    ours, want = roofline.RooflineReport(**kw), jax_roofline.RooflineReport(**kw)
    assert ours.compute_term_s == flops / 989e12
    assert ours.memory_term_s == nbytes / 3.35e12
    assert ours.collective_term_s == coll / 450e9
    terms = {"compute": ours.compute_term_s, "memory": ours.memory_term_s,
             "collective": ours.collective_term_s}
    assert ours.bottleneck == max(terms, key=terms.get)
    assert ours.model_flops_ratio == want.model_flops_ratio
    d = ours.to_dict()
    assert set(d) == set(want.to_dict()) and d["collective_counts"] == {"all-reduce": [2, 10]}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equals_jax(kind):
    assert roofline.model_flops(877_000_000, 4096, kind) == jax_roofline.model_flops(877_000_000, 4096, kind)
