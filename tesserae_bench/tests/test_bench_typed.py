"""The typed cell ``hetero256-backlog`` at a size a test run holds: its own
tiny cut (``conftest.tiny_cell`` cuts only ``num_nodes``, and a typed
cluster's ``node_gpu_types`` has one entry a node), which comes out
``correct`` on the CPU; the control and the packing fault, judged by the
typed reference, come out not correct, and so do the program with a step
that returns its state unchanged, with half its fan-out left out, and with
the node match's rack term dropped (the type penalty kept); the
configuration follows the reference's rule; the traffic's band at the tiny
cut; and the reader of ``hetero_terms_ms``."""

import copy

import numpy as np
import pytest
import torch

from tesserae_bench import control, harness, traffic

from test_bench_faults import _half_fanout, _unchanged
from test_bench_span_readers import ctx_of, sp, window

CELL = "hetero256-backlog"
ref = harness.load_module("reference", "tesserae_round_typed")


def typed_tiny_cell(nodes=8, warmup=6, live=2, rounds=400, reference_rounds=3):
    """The cell's files with the cluster cut to ``nodes`` nodes by the
    configuration's rule, a short warm-up and trace, and
    ``reference_rounds`` rounds judged in full."""
    manifest = harness.load_manifest()
    cell, config, mix = harness.resolve(manifest, CELL)
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["cluster"] = ref.cluster(nodes, config["cluster"]["gpus_per_node"])
    mix.update(warmup_rounds=warmup, live_rounds=live, trace_rounds=warmup + rounds,
               reference_rounds=reference_rounds)
    return manifest, (cell, config, mix)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    manifest, cell_data = typed_tiny_cell()
    out = harness.run_cell(
        CELL, 2**31 + 17, 2.0, False, "cpu", manifest=manifest, cell_data=cell_data,
        keep_rounds=True, cache_dir=tmp_path_factory.mktemp("typed"),
    )
    return out, cell_data[1], cell_data[2]


def test_typed_cut_is_correct_on_the_cpu(tiny_run):
    out, config, _ = tiny_run
    assert out["correct"], out["compared"]
    assert out["attempted"] == out["window"]["rounds"] > 0 and out["failed"] == 0
    types = ref.node_types(config["cluster"]["num_nodes"])
    for r in out["rounds"]:
        assert np.array_equal(types[r["node_assignment"]], types)


@pytest.mark.parametrize("fault", ["relabel", "packing"])
def test_control_and_packing_fault_are_not_correct(tiny_run, fault):
    out, config, mix = tiny_run
    table = ref.Jobs(out["jobs"])
    gpn = config["cluster"]["gpus_per_node"]
    judge = {
        "relabel": lambda r: control.relabel(r, table, gpn),
        "packing": lambda r: control.packing(r, table),
    }[fault]
    compared, bad = harness.check(
        out["rounds"], out["jobs"], config, dict(mix, reference_rounds=len(out["rounds"])), 7,
        judge=judge,
    )
    assert bad > 0
    assert not all(v["value"] <= v["limit"] for v in compared.values())


def _no_rack_term(monkeypatch):
    import repro_torch.core.migration as migration

    monkeypatch.setattr(migration, "CROSS_RACK_COST", 0.0)  # the type penalty stays


@pytest.mark.parametrize("fault", [_unchanged, _half_fanout, _no_rack_term])
def test_a_broken_typed_path_is_not_correct(fault, monkeypatch, tmp_path):
    """Every round of the window judged in full: without the rack term the
    relabel crosses racks where a move within its rack costs the same, in
    about one round in six at this cut."""
    fault(monkeypatch)
    manifest, cell_data = typed_tiny_cell(reference_rounds=10**6)
    out = harness.run_cell(
        CELL, 2**31 + 17, 2.0, False, "cpu", manifest=manifest, cell_data=cell_data,
        keep_rounds=True, cache_dir=tmp_path,
    )
    assert not out["correct"], out["compared"]
    assert out["failed"] > 0


def test_configuration_follows_the_reference_rule():
    _, config, _ = harness.resolve(harness.load_manifest(), CELL)
    cl = config["cluster"]
    assert cl == ref.cluster(cl["num_nodes"], cl["gpus_per_node"])
    assert cl["num_nodes"] == 64 and cl["nodes_per_rack"] == 16
    assert cl["node_gpu_types"] == ["a100"] * 32 + ["v100"] * 32
    assumed = config["assumed"]["gpu_types"]
    assert {t: (v["mem_gb"], v["speed"]) for t, v in assumed.items()} == ref.GPU_TYPES
    assert config["reference"] == "tesserae_round_typed"


def test_stationarity_band_at_a_typed_tiny_cluster():
    """After the warm-up, the active jobs, pending jobs and GPUs placed per
    GPU stay inside ``band.tiny``, at the typed tiny cut, on the CPU's
    exact host solvers."""
    _, config, mix = harness.resolve(harness.load_manifest(), CELL)
    band = mix["band"]["tiny"]
    config = copy.deepcopy(config)
    config["cluster"] = ref.cluster(band["nodes"], config["cluster"]["gpus_per_node"])
    config["scheduler"]["lap_backend"] = "auto"
    ng = band["nodes"] * config["cluster"]["gpus_per_node"]
    jobs = traffic.make_trace(mix, ng, 3, 360.0)
    counts = []

    def hook(r, now, d, states, health):
        if r > mix["warmup_rounds"]:
            counts.append((len(d.placed) + len(d.pending), len(d.pending),
                           int((d.plan.slots != -1).any(-1).sum())))

    sim, _ = harness.build_system(config, jobs, torch.device("cpu"), hook, None)
    assert sim.run(stop_after_rounds=mix["warmup_rounds"] + band["rounds"]) is None
    c = np.array(counts) / ng
    for i, key in enumerate(("active_per_gpu", "pending_per_gpu", "placed_gpu_share")):
        lo, hi = band[key]
        assert lo <= c[:, i].min() and c[:, i].max() <= hi, (key, c[:, i].min(), c[:, i].max())


def _typed_window(pen_ms, types_ms):
    """One round per entry: a ``migrate.penalties`` and a ``pack.types``
    span of those wall times (None: the span is absent)."""
    roots = []
    for p, t in zip(pen_ms, types_ms):
        pack = [sp("pack.graph", 4)] + ([] if t is None else [sp("pack.types", t, rows=3)])
        mig = [sp("migrate.cost", 1)] + ([] if p is None else [sp("migrate.penalties", p, types=2, racks=4)])
        roots.append(sp("round", children=[sp("decide", children=[
            sp("pack", children=pack), sp("migrate.host", children=mig)])]))
    return ctx_of(roots, rounds=len(pen_ms))


def test_hetero_terms_reader():
    read = harness.load_module("metrics", "hetero_terms_ms").read
    assert read(_typed_window([0.5, 0.7], [0.2, 0.4])) == pytest.approx((0.5 + 0.7 + 0.2 + 0.4) / 2)
    # the first round has no previous plan, so no relabel
    assert read(_typed_window([None, 0.7], [0.2, 0.4])) == pytest.approx((0.7 + 0.2 + 0.4) / 2)
    assert read(_typed_window([None, None], [None, None])) is None
    assert read(window()) is None  # the paper cell's spans
    assert read(ctx_of([])) is None
    assert read(ctx_of([], rounds=0)) is None
