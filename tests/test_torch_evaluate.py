"""The port's evaluation harness (``repro_torch.benchmarks``) on the CPU.

``BENCH_endtoend.json`` is the JAX package's record of the paper's policy
comparison (5 policies x 8 scenarios, 48 GPUs, 100 jobs, seed 0, backend
``auto``).  The port's ``run_arm`` must reproduce every arm's decisions
exactly — JCTs, makespan, migrations, rounds, the fault counters with the
degrade tags and failed jobs, and the matching telemetry — wall times
excluded.  The record is read as a file; the JAX repo's ``benchmarks/``
is never imported.
"""

import json
import math
from pathlib import Path

import pytest

from repro_torch.benchmarks import evaluate, scalability
from repro_torch.benchmarks.common import build_scheduler
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.profiler import ThroughputProfile
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_endtoend.json").read_text())
ARMS = {(a["policy"], a["scenario"]): a for a in RECORD["arms"]}
#: wall-clock measurements, not decisions.  ``decide_p50_s`` /
#: ``decide_p99_s`` (``SimResult.summary``'s decide latency) are newer than
#: the record: both packages' harnesses write them today
WALL = ("wall_s",)
WALL_METRICS = ("overhead_total_s", "decide_p50_s", "decide_p99_s")
#: the five arms that cover every policy, faults, hetero and the loader
NAMED = [
    ("tesserae-t-fa", "philly-like-burst"),
    ("tiresias", "node-flaky"),
    ("gavel", "philly-sample"),
    ("tesserae-t", "philly-failures"),
    ("tiresias-single", "hetero-mixed"),
]


def _decisions(arm):
    out = {k: v for k, v in arm.items() if k not in WALL}
    out["metrics"] = {k: v for k, v in arm["metrics"].items() if k not in WALL_METRICS}
    return out


def test_record_is_the_default_configuration():
    cfg = RECORD["config"]
    assert tuple(cfg["policies"]) == evaluate.DEFAULT_POLICIES
    assert tuple(cfg["scenarios"]) == evaluate.DEFAULT_SCENARIOS
    assert (cfg["num_gpus"], cfg["num_jobs"], cfg["seed"], cfg["backend"]) == (48, 100, 0, "auto")
    assert set(NAMED) <= set(ARMS) and len(ARMS) == 40


@pytest.mark.parametrize("policy,scenario", sorted(ARMS), ids=lambda x: x)
def test_run_arm_equals_the_record(policy, scenario):
    """Every arm of the record, on the CPU: the decisions exactly."""
    got = evaluate.run_arm(policy, scenario, 48, 100, 0, "auto", device="cpu")
    want = ARMS[(policy, scenario)]
    assert set(got) == set(want)
    assert set(got["metrics"]) == set(want["metrics"]) | {"decide_p50_s", "decide_p99_s"}
    assert _decisions(got) == _decisions(want)
    assert all(math.isfinite(got["metrics"][k]) for k in WALL_METRICS)


def test_derive_speedups_reproduces_the_record():
    got = evaluate.derive_speedups(RECORD["arms"], "tesserae-t")
    assert got == RECORD["speedups_vs_tesserae-t"]


def test_validate_schema_accepts_the_record_and_names_what_breaks():
    assert evaluate.validate_schema(RECORD) == []
    broken = json.loads(json.dumps(RECORD))
    arm = broken["arms"][3]
    arm["metrics"]["p99_jct_s"] = float("nan")
    del arm["match_telemetry"]["bid_iters"]
    del arm["faults"]["retries_total"]
    arm["metrics"]["rounds"] = 0
    problems = evaluate.validate_schema(broken)
    tag = f"{arm['policy']}/{arm['scenario']}"
    assert len(problems) == 4 and all(p.startswith(tag) for p in problems)


def test_sweep_document_has_the_records_schema():
    doc = evaluate.run_sweep(("tesserae-t", "tiresias"), ("philly-sample",), 16, 12, 0, "auto",
                             verbose=False, device="cpu")
    assert set(doc) == set(RECORD)
    assert set(doc["config"]) == set(RECORD["config"])
    for arm in doc["arms"]:
        assert set(arm) == set(RECORD["arms"][0])
        for key in ("match_telemetry", "faults"):
            assert set(arm[key]) == set(RECORD["arms"][0][key])
        assert set(arm["metrics"]) - set(RECORD["arms"][0]["metrics"]) == set(WALL_METRICS[1:])
    assert evaluate.validate_schema(doc) == []


@pytest.mark.parametrize("lane", ["--smoke", "--chaos"])
def test_ci_lanes_pass_on_the_cpu(tmp_path, lane, capsys):
    out = tmp_path / "doc.json"
    assert evaluate.main(["--device", "cpu", lane, "--json", str(out)]) == 0
    assert "PASS" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert evaluate.validate_schema(doc) == []


def test_the_default_device_is_the_card(monkeypatch):
    """No ``--device``: the schedulers ask for CUDA, which raises without
    one rather than running on the CPU unasked."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.run_arm("tiresias", "poisson-steady", 16, 8, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        scalability.main(["--skip-cluster-sweep"])


@pytest.mark.parametrize(
    "name",
    ["tiresias", "tiresias-single", "tesserae-t", "tesserae-t-fa", "tesserae-t-nomig", "gavel",
     "gavel-ftf", "tesserae-ftf", "ftf"],
)
def test_build_scheduler_names(name):
    sched = build_scheduler(name, ClusterSpec(4, 4), ThroughputProfile(), device="cpu")
    assert sched.device.type == "cpu"
    assert sched.enable_packing == (name not in ("tiresias", "ftf"))
    node = name.startswith("tesserae") and name != "tesserae-t-nomig"
    assert sched.migration_algorithm == ("node" if node else "none")
    assert sched.health_aware == (name == "tesserae-t-fa")


def test_build_scheduler_rejects_an_unknown_name():
    with pytest.raises(ValueError):
        build_scheduler("srtf-tesserae", ClusterSpec(4, 4), ThroughputProfile(), device="cpu")


def test_scalability_records_on_the_cpu():
    """Part 1 at 128 jobs with the LP rows, Part 2 on a 64-GPU cluster with
    the exact and the kernel backends (the plain loop on the CPU)."""
    rows, records = [], []
    prof = ThroughputProfile()
    scalability.bench_paper_figure(prof, rows, records, "auto", "cpu", job_counts=[128])
    scalability.bench_cluster_scale(prof, rows, records, ["scipy", "auction_kernel"], "cpu",
                                    clusters=[(16, 4)])
    benches = [r["bench"] for r in records]
    assert benches == ["decision_time", "lp_baseline", "lp_baseline", "cluster_scale",
                       "cluster_scale"]
    for r in records:
        for key in ("total_s", "warm_total_s", "time_s"):
            if key in r:
                assert math.isfinite(r[key]) and r[key] >= 0.0
    scale = [r for r in records if r["bench"] == "cluster_scale"]
    assert [r["backend"] for r in scale] == ["scipy", "auction_kernel"]
    assert all(r["gpus"] == 64 and "warm_match_stats" in r for r in scale)
    assert len(rows) == 5
