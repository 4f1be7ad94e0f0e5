"""The port's Tesserae round on a mixed-generation, racked cluster, judged
by the benchmark's typed reference (``tesserae_bench/reference/
tesserae_round_typed.py``, NumPy and SciPy, loaded by its file path as the
benchmark's harness loads it).

An 8-node cut of the ``hetero-256gpu`` configuration (4 A100 + 4 V100
nodes, racks of 2) runs the benchmark's traffic through ``Simulator.run``
on the CPU for a fixed number of rounds, and every round is judged: no
infeasible plan, the relabel at the penalised node match's optimum, packing
within its stated bound, no logical node relabelled across types.  The
reference's penalties equal ``core.migration._relabel_penalties`` on
random typed and racked clusters, its per-type weights equal the port's
profiles, and three faults of the typed semantics in the port come out not
correct: the node match without its penalties, without only its rack term,
and A100 weights on V100 rows.
"""

import copy
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the reference imports the benchmark's frozen tables

from tesserae_bench import harness, traffic  # noqa: E402

ref = harness.load_module("reference", "tesserae_round_typed")

WARM, ROUNDS = 20, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other CPU ``test_torch_*`` files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _typed_cut(nodes=8):
    """The cell's configuration cut to ``nodes`` nodes by its rule, and its
    traffic with a warm-up of ``WARM`` rounds."""
    _, config, mix = harness.resolve(harness.load_manifest(), "hetero256-backlog")
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["cluster"] = ref.cluster(nodes, config["cluster"]["gpus_per_node"])
    mix.update(warmup_rounds=WARM, live_rounds=2, trace_rounds=WARM + 200, reference_rounds=ROUNDS)
    return config, mix


def _judged_rounds(seed):
    """``ROUNDS`` rounds after the warm-up, recorded as the benchmark
    records them, and the reference's verdict on every one."""
    config, mix = _typed_cut()
    num_gpus = config["cluster"]["num_nodes"] * config["cluster"]["gpus_per_node"]
    jobs = traffic.make_trace(mix, num_gpus, seed, 360.0)
    rec = harness.Recorder(360.0)
    sim, sched = harness.build_system(config, jobs, torch.device("cpu"), rec.hook, None)
    rec.install(sched)
    try:
        assert sim.run(stop_after_rounds=WARM) is None
        rec.keep = True
        assert sim.run(stop_after_rounds=ROUNDS) is None
    finally:
        rec.uninstall()
    assert len(rec.rounds) == ROUNDS
    compared, bad = harness.check(rec.rounds, jobs, config, mix, seed)
    return rec.rounds, compared, bad


@pytest.mark.parametrize("seed", [3, 2**31 + 17, 2**33 + 5])
def test_typed_rounds_match_the_reference(seed):
    rounds, compared, bad = _judged_rounds(seed)
    assert bad == 0, compared
    assert compared["infeasible_rounds"]["value"] == 0
    assert compared["relabel_gap"]["value"] == 0
    assert compared["pack_gap_over_bound"]["value"] <= compared["pack_gap_over_bound"]["limit"]
    assert compared["k5_cells_off"]["value"] == compared["fanout_pairs_off"]["value"] == 0
    types = ref.node_types(8)
    for r in rounds:
        assert np.array_equal(types[r["node_assignment"]], types)
    # the rounds pack pairs on both types
    kinds = set()
    for r in rounds:
        tq = dict(zip(r["placed"].tolist(), ref.placed_types(r).tolist()))
        kinds |= {tq[q] for q in r["matches"].values()}
    assert kinds == {0, 1}


@pytest.mark.parametrize("kc,gpn,trial", list(itertools.product([4, 8, 16], [2, 4], range(3))))
def test_reference_penalties_equal_the_program(kc, gpn, trial):
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.migration import _relabel_penalties

    rng = np.random.default_rng([kc, gpn, trial])
    names = np.array(["a100", "v100", "tpu-v5e"])[rng.integers(0, 3, size=kc)]
    per_rack = int(rng.integers(0, kc + 1))
    cluster = ClusterSpec(kc, gpn, node_gpu_types=tuple(names), nodes_per_rack=per_rack)
    racks = np.arange(kc) // per_rack if per_rack else np.zeros(kc, np.int64)
    want = _relabel_penalties(cluster)
    got = ref.penalties(names, racks, gpn)
    assert np.array_equal(got, np.zeros((kc, kc)) if want is None else want)


@pytest.mark.parametrize("nodes", [4, 8, 64])
def test_reference_rule_penalties_equal_the_configured_cluster(nodes):
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.migration import _relabel_penalties

    cluster = ClusterSpec(**ref.cluster(nodes, 4))
    want = _relabel_penalties(cluster)
    assert np.array_equal(ref.penalties(ref.node_types(nodes), ref.node_racks(nodes), 4), want)


def test_reference_typed_weights_equal_the_program_profiles():
    from repro_torch.core.profiler import GPU_TYPES, ThroughputProfile

    prof = ThroughputProfile()
    for t in ref.TYPE_NAMES:
        assert ref.GPU_TYPES[t] == (GPU_TYPES[t].mem_gb, GPU_TYPES[t].speed)
        typed = prof.for_gpu_type(t)
        for a, b in itertools.product(ref.tput.MODELS, repeat=2):
            assert ref.combined_weight(a, b, t) == typed.combined_weight(a, b)[0], (t, a, b)
    # the 16 GB part cuts pairs the A100 packs
    cut = [(a, b) for a, b in itertools.product(ref.tput.MODELS, repeat=2)
           if ref.combined_weight(a, b, "a100") > 0 and ref.combined_weight(a, b, "v100") == 0]
    assert ("gpt3-medium", "vgg19") in cut


def _unpenalised(monkeypatch):
    import repro_torch.core.migration as mig

    monkeypatch.setattr(mig, "_relabel_penalties", lambda *a, **k: None)


def _no_rack_term(monkeypatch):
    import repro_torch.core.migration as mig

    monkeypatch.setattr(mig, "CROSS_RACK_COST", 0.0)  # the type penalty stays


def _a100_weights(monkeypatch):
    import repro_torch.core.scheduler as sch

    orig = sch.pack_jobs
    monkeypatch.setattr(sch, "pack_jobs", lambda *a, **k: orig(*a, **dict(k, placed_gpu_types=None)))


@pytest.mark.parametrize(
    "fault,number",
    [(_unpenalised, "relabel_gap"), (_no_rack_term, "relabel_gap"),
     (_a100_weights, "infeasible_rounds")],
    ids=["unpenalised-node-match", "no-rack-term", "a100-weights-on-v100-rows"],
)
def test_typed_faults_are_not_correct(fault, number, monkeypatch):
    fault(monkeypatch)
    _, compared, bad = _judged_rounds(3)
    assert bad > 0
    assert compared[number]["value"] > compared[number]["limit"]
