"""The port's dry-run (``launch/dryrun.py``) against the JAX package's, on
the CPU.

The reference's ``launch/dryrun.py`` rewrites ``XLA_FLAGS`` when it is
imported, so its side runs in a subprocess, as
``test_dryrun_integration.py`` runs it: its ``rules_for``,
``dryrun_train_config`` and, from ``jax.eval_shape`` trees on its 512-device
production meshes, the state bytes per device of every full config, shape
and mesh.  It lowers nothing (ROADMAP D18).  Against those, the port's
rules, train policy and fake-tensor state, exactly; then the port's own
counts: on every reduced config and every kind the count on fake tensors
equals the same counter over real CPU tensors and, in FLOPs,
``FlopCounterMode``; the CLI's counterparts of the reference's three
integration cases; and ``REPRO_MOE_GROUPS`` restored after a failure.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import roofline
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.launch.specs import INPUT_SHAPES, InputShape
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's side: rules, train policy and state bytes of every full
#: config, shape and mesh, as one JSON object on stdout
REFERENCE = r'''
import json, os
import repro.launch.dryrun as D  # sets XLA_FLAGS (512 host devices) before jax loads
import jax
from repro.configs import get_config, list_archs
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import (INPUT_SHAPES, bytes_per_device, cache_logical_axes,
                                logical_axes_for, sharding_tree)
from repro.models import get_model
from repro.serve.engine import ServeConfig
from repro.train.step import train_state_init

out = {"rules": {}, "train_config": {}, "state_bytes": {}}
meshes = {m: make_production_mesh(multi_pod=m) for m in (False, True)}
rng = jax.random.PRNGKey(0)
for arch in list_archs():
    cfg = get_config(arch)
    for mb in (None, "4"):
        if mb:
            os.environ["REPRO_MICROBATCHES"] = mb
        tc = D.dryrun_train_config(cfg)
        os.environ.pop("REPRO_MICROBATCHES", None)
        out["train_config"][f"{arch}|{mb}"] = [tc.optimizer.moment_dtype, tc.microbatches]
    params = jax.eval_shape(lambda r: get_model(cfg).init(r, cfg), rng)
    for name, shape in INPUT_SHAPES.items():
        for multi, mesh in meshes.items():
            for opt in (None, "1"):
                if opt:
                    os.environ["REPRO_OPT_DECODE_CACHE"] = opt
                r = D.rules_for(cfg, shape, mesh)
                os.environ.pop("REPRO_OPT_DECODE_CACHE", None)
                out["rules"][f"{arch}|{name}|{multi}|{opt}"] = [
                    {k: list(v) if isinstance(v, tuple) else v for k, v in r.rules.items()},
                    list(r.dp_axes)]
            rules = D.rules_for(cfg, shape, mesh)
            if shape.kind == "train":
                st = jax.eval_shape(lambda r: train_state_init(r, cfg, D.dryrun_train_config(cfg)), rng)
                b = bytes_per_device(st, sharding_tree(st, rules, logical_axes_for))
            else:
                b = bytes_per_device(params, sharding_tree(params, rules, logical_axes_for))
                if shape.kind == "decode":
                    sc = ServeConfig(batch_size=shape.global_batch, context_len=shape.seq_len)
                    cache = jax.eval_shape(
                        lambda: get_model(cfg).init_cache(cfg, sc.batch_size, sc.cache_len(cfg)))
                    b += bytes_per_device(cache, sharding_tree(cache, rules, cache_logical_axes))
            out["state_bytes"][f"{arch}|{name}|{multi}"] = b
print(json.dumps(out))
'''

#: the counterparts of ``test_dryrun_integration.py``'s three cases
CLI_CASES = {
    "mamba2-780m-decode_32k": ["--arch", "mamba2-780m", "--shape", "decode_32k", "--no-correct"],
    "qwen2-vl-2b-prefill_32k": ["--arch", "qwen2-vl-2b", "--shape", "prefill_32k", "--no-correct"],
    "multi-pod": ["--arch", "mamba2-780m", "--shape", "decode_32k", "--multi-pod", "--no-correct"],
}

#: state bytes per device on the single-pod mesh, from the reference's
#: ``jax.eval_shape`` trees (pinned as numbers too)
PINNED = {
    ("llama3-8b", "train_4k"): 473_620_484, ("llama3-8b", "prefill_32k"): 94_724_096,
    ("llama3-8b", "decode_32k"): 17_274_593_280, ("llama3-8b", "long_500k"): 228_941_824,
    ("nemotron-4-340b", "train_4k"): 9_925_079_044,
    ("nemotron-4-340b", "prefill_32k"): 3_308_359_680,
    ("nemotron-4-340b", "decode_32k"): 80_617_771_008,
    ("nemotron-4-340b", "long_500k"): 3_912_339_456,
    ("mamba2-780m", "train_4k"): 85_983_748, ("mamba2-780m", "prefill_32k"): 17_207_808,
    ("mamba2-780m", "decode_32k"): 62_624_256, ("mamba2-780m", "long_500k"): 22_884_864,
    ("dbrx-132b", "train_4k"): 3_266_088_964, ("dbrx-132b", "prefill_32k"): 1_089_024_000,
    ("dbrx-132b", "decode_32k"): 22_563_860_480, ("dbrx-132b", "long_500k"): 1_256_796_160,
}

#: small shapes of each kind for the reduced configs (S a multiple of the
#: reduced SSM chunk)
SMALL = [InputShape("small_train", 64, 4, "train"), InputShape("small_prefill", 64, 2, "prefill"),
         InputShape("small_decode", 64, 2, "decode")]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return env


@pytest.fixture(scope="module")
def background():
    """The reference's side and the CLI cases, started together in
    subprocesses; each read once, when first asked for."""
    procs = {"reference": subprocess.Popen([sys.executable, "-c", REFERENCE], stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO)}
    for name, args in CLI_CASES.items():
        procs[name] = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                       env=_env(), cwd=REPO)
    done = {}

    def result(name):
        if name not in done:
            out, err = procs[name].communicate(timeout=600)
            done[name] = (procs[name].returncode, out, err)
        return done[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def reference(background):
    rc, out, err = background("reference")
    assert rc == 0, err[-2000:]
    return json.loads(out.splitlines()[-1])


# --------------------------------------------------------------------------- #
# the rules and the train policy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list_archs())
def test_rules_for_equals_jax(monkeypatch, reference, arch):
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            for opt in (None, "1"):
                if opt:
                    monkeypatch.setenv("REPRO_OPT_DECODE_CACHE", opt)
                else:
                    monkeypatch.delenv("REPRO_OPT_DECODE_CACHE", raising=False)
                r = dryrun.rules_for(cfg, shape, mesh)
                got = [{k: list(v) if isinstance(v, tuple) else v for k, v in r.rules.items()},
                       list(r.dp_axes)]
                assert got == reference["rules"][f"{arch}|{name}|{multi}|{opt}"], (name, multi, opt)
                assert r.mesh is mesh


@pytest.mark.parametrize("arch", list_archs())
def test_dryrun_train_config_equals_jax(monkeypatch, reference, arch):
    cfg = get_config(arch)
    for mb in (None, "4"):
        if mb:
            monkeypatch.setenv("REPRO_MICROBATCHES", mb)
        else:
            monkeypatch.delenv("REPRO_MICROBATCHES", raising=False)
        tc = dryrun.dryrun_train_config(cfg)
        assert [tc.optimizer.moment_dtype, tc.microbatches] == reference["train_config"][f"{arch}|{mb}"]


def test_the_microbatch_cap_and_the_moe_groups_are_the_references(monkeypatch):
    """``run_dryrun``'s inline arithmetic in the reference: microbatches
    capped at ``global_batch // dp`` (at least 1), and ``REPRO_MOE_GROUPS``
    the data-parallel size where it divides one call's tokens."""
    monkeypatch.delenv("REPRO_MICROBATCHES", raising=False)
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    train = INPUT_SHAPES["train_4k"]
    dbrx, llama = get_config("dbrx-132b"), get_config("llama3-8b")
    assert dryrun.train_config_for(dbrx, train, single).microbatches == 16  # 256 // 16
    assert dryrun.train_config_for(dbrx, train, multi).microbatches == 8  # 256 // 32
    assert dryrun.train_config_for(llama, train, multi).microbatches == 8
    monkeypatch.setenv("REPRO_MICROBATCHES", "64")
    assert dryrun.train_config_for(llama, train, single).microbatches == 16
    tc = dryrun.train_config_for(dbrx, train, single)
    assert dryrun.moe_groups(dbrx, train, single, tc) == 16
    assert dryrun.moe_groups(dbrx, INPUT_SHAPES["prefill_32k"], multi, None) == 32
    assert dryrun.moe_groups(dbrx, INPUT_SHAPES["decode_32k"], multi, None) == 32  # 128 % 32
    assert dryrun.moe_groups(dbrx, INPUT_SHAPES["long_500k"], single, None) == 1  # 1 token
    assert dryrun.moe_groups(llama, INPUT_SHAPES["prefill_32k"], single, None) == 1  # dense


# --------------------------------------------------------------------------- #
# state bytes per device: every full config, shape and mesh
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def port_state_bytes():
    """The port's state bytes of every full config, shape and mesh, from
    the dry-run's own :func:`state_trees` (fake tensors) and
    :func:`sharded_state`."""
    out = {}
    for arch in list_archs():
        cfg = get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            with FakeTensorMode(allow_non_fake_inputs=True):
                tc = dryrun.dryrun_train_config(cfg) if shape.kind == "train" else None
                trees = dryrun.state_trees(cfg, shape, tc, torch.Generator().manual_seed(0))
                for multi in (False, True):
                    mesh = make_production_mesh(multi_pod=multi)
                    out[arch, name, multi] = dryrun.sharded_state(
                        trees, dryrun.rules_for(cfg, shape, mesh))[0]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", list_archs())
def test_state_bytes_per_device_equal_jax(reference, port_state_bytes, arch):
    for name in INPUT_SHAPES:
        for multi in (False, True):
            assert port_state_bytes[arch, name, multi] == \
                reference["state_bytes"][f"{arch}|{name}|{multi}"], (name, multi)


def test_state_bytes_pinned_on_the_single_pod_mesh(port_state_bytes):
    assert {k: port_state_bytes[k[0], k[1], False] for k in PINNED} == PINNED


def test_fake_state_allocates_nothing():
    """Nemotron's train state is terabytes: under ``FakeTensorMode`` none of
    it is allocated."""
    cfg = get_config("nemotron-4-340b")
    shape = INPUT_SHAPES["train_4k"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        trees = dryrun.state_trees(cfg, shape, dryrun.dryrun_train_config(cfg), torch.Generator())
        leaves = _leaves(trees["state"][0])
        total = sum(t.numel() * t.element_size() for t in leaves)
        assert total > 2e12
        assert all(type(t).__name__ == "FakeTensor" for t in leaves)


# --------------------------------------------------------------------------- #
# the counter
# --------------------------------------------------------------------------- #
def test_step_counter_charges_state_at_its_shard_and_the_rest_over_the_chips():
    w = torch.ones((64, 32))  # a state leaf cut 4 ways
    x = torch.ones((8, 64))
    with dryrun.StepCounter(chips=16, state_shards={w.untyped_storage()._cdata: 4}) as c:
        wt = w.reshape(32, 64).t()  # views: counted nowhere, still the state's storage
        y = x @ wt
        torch.relu(y)
    assert c.flops == 2 * 8 * 64 * 32
    assert c.bytes_by_split == {4: 64 * 32 * 4, 16: (8 * 64 + 2 * 8 * 32 + 8 * 32) * 4}
    assert c.bytes == (64 * 32 + 8 * 64 + 3 * 8 * 32) * 4
    assert c.bytes_per_device == 64 * 32 * 4 / 4 + (8 * 64 + 3 * 8 * 32) * 4 / 16


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape", SMALL, ids=lambda s: s.kind)
def test_fake_count_equals_the_real_count_and_flop_counter_mode(arch, shape):
    """Every reduced config and every kind on the production mesh: the
    dry-run's count on fake tensors equals the same counter over real CPU
    tensors exactly, in FLOPs, bytes and state bytes; the FLOPs equal
    ``FlopCounterMode``'s over the real run (which counts no init: it has
    no product)."""
    cfg = get_reduced(arch)
    mesh = make_production_mesh()
    fake = dryrun.count_step(cfg, shape, mesh)
    with FlopCounterMode(display=False) as fc:
        real = dryrun.count_step(cfg, shape, mesh, fake=False)
    assert fake.flops > 0 and fake.bytes > 0
    assert (fake.flops, fake.bytes, fake.state_bytes_per_device) == \
        (real.flops, real.bytes, real.state_bytes_per_device)
    assert fake.bytes_per_device == real.bytes_per_device
    assert fc.get_total_flops() == real.flops
    assert fake.chips == 256 and fake.flops_per_device == fake.flops / 256


def test_on_a_one_by_one_mesh_the_split_is_exact():
    """On the smoke mesh every tensor is one device's: the bytes per device
    are every byte counted, and the state bytes are the params' own."""
    cfg = get_reduced("llama3-8b")
    shape = InputShape("small_prefill", 64, 2, "prefill")
    count = dryrun.count_step(cfg, shape, make_smoke_mesh(), fake=False)
    params = dryrun.state_trees(cfg, shape, None, torch.Generator().manual_seed(0))["params"][0]
    assert count.chips == 1
    assert count.bytes_per_device == count.bytes and count.flops_per_device == count.flops
    assert count.state_bytes_per_device == sum(t.numel() * t.element_size() for t in _leaves(params))


@pytest.mark.parametrize("saved", [None, "3"])
def test_moe_groups_is_restored_after_a_failing_combination(monkeypatch, saved):
    if saved is None:
        monkeypatch.delenv("REPRO_MOE_GROUPS", raising=False)
    else:
        monkeypatch.setenv("REPRO_MOE_GROUPS", saved)
    seen = []

    def failing_step(*args):
        def run():
            seen.append(os.environ.get("REPRO_MOE_GROUPS"))
            raise RuntimeError("this combination fails")
        return run

    monkeypatch.setattr(dryrun, "_step", failing_step)
    with pytest.raises(RuntimeError, match="this combination fails"):
        dryrun.count_step(get_reduced("dbrx-132b"), InputShape("small_prefill", 64, 2, "prefill"),
                          make_production_mesh())
    assert seen == ["16"]  # 128 tokens over the 16-way data axis
    assert os.environ.get("REPRO_MOE_GROUPS") == saved


def test_run_dryrun_fills_the_references_report(monkeypatch, capsys):
    """``run_dryrun`` on a reduced config (``get_config`` patched): the
    report's fields, the model FLOPs from the active params, no collective
    term, no memory analysis, no HLO."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    res = dryrun.run_dryrun("dbrx-132b", "decode_32k", multi_pod=True, keep_hlo=True)
    cfg, rep = get_reduced("dbrx-132b"), res.report
    assert res.ok and res.hlo is None and res.error is None
    assert (rep.arch, rep.shape, rep.mesh, rep.chips) == ("dbrx-132b", "decode_32k", "2x16x16", 512)
    assert rep.model_flops_total == roofline.model_flops(cfg.active_param_count(), 128, "decode")
    assert rep.collective_bytes_per_device == 0 and rep.collective_counts == {}
    assert rep.peak_memory_per_device is None
    assert res.memory_analysis.startswith("<memory_analysis unavailable: ")
    assert rep.hlo_flops_per_device > 0 and rep.hlo_bytes_per_device > 0
    assert res.state_bytes_per_device > 0 and res.compile_s > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "== dryrun dbrx-132b x decode_32k on mesh 2x16x16 =="
    d = json.loads(lines[-1])
    assert d == {**rep.to_dict(), "compile_s": res.compile_s,
                 "state_bytes_per_device": res.state_bytes_per_device}


# --------------------------------------------------------------------------- #
# the CLI: the reference's three integration cases
# --------------------------------------------------------------------------- #
def _report(background, name):
    rc, out, err = background(name)
    assert rc == 0, err[-2000:]
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


@pytest.mark.parametrize("name", ["mamba2-780m-decode_32k", "qwen2-vl-2b-prefill_32k"])
def test_single_pod_dryrun_runs(background, name):
    d = _report(background, name)
    assert d["chips"] == 256 and d["mesh"] == "16x16"
    assert d["hlo_flops_per_device"] > 0
    assert d["bottleneck"] in ("compute", "memory", "collective")


def test_multi_pod_dryrun_runs_with_no_collective_term(background):
    """The reference requires collective bytes here; the port has no
    partitioner, so its collective term is zero by construction (ROADMAP
    D17)."""
    d = _report(background, "multi-pod")
    assert d["chips"] == 512 and d["mesh"] == "2x16x16"
    assert d["hlo_flops_per_device"] > 0
    assert d["collective_bytes_per_device"] == 0 and d["collective_counts"] == {}
    assert d["collective_term_s"] == 0 and d["bottleneck"] != "collective"
    assert math.isclose(d["memory_term_s"], d["hlo_bytes_per_device"] / roofline.HBM_BW)


def test_the_cli_exits_1_and_names_a_failing_combination():
    res = subprocess.run([sys.executable, "-c",
                          "import sys; from repro_torch.launch import dryrun; "
                          "dryrun.count_step = lambda *a, **k: 1 / 0; "
                          "sys.argv = ['dryrun', '--arch', 'llama3-8b', '--shape', 'decode_32k']; "
                          "dryrun.main()"],
                         capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert res.returncode == 1
    assert "FAILED llama3-8b x decode_32k: ZeroDivisionError" in res.stderr


def test_the_dryrun_module_sets_no_environment_at_import():
    code = ("import os; before = dict(os.environ); import repro_torch.launch.dryrun; "
            "assert dict(os.environ) == before; import sys; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(),
                         cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
