"""The port's workload lab (``repro_torch.workloads``) against the JAX
package's (``repro.workloads``), on the CPU.

Both are numpy code over seeded generators; the port keeps its own copy
(importing ``repro.workloads`` would pull in JAX through ``repro.core``).
Here the same seeds go through both: every registered scenario's trace and
failure stream, every generator kind, the cluster factories, and the files
each package writes are read by the other.
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest

import repro.workloads as jwl
import repro_torch.workloads as twl
from repro.core.cluster import ClusterSpec as JaxClusterSpec
from repro.workloads import loaders as jloaders
from repro_torch.core.cluster import ClusterSpec
from repro_torch.workloads import loaders as tloaders
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

SCENARIOS = twl.list_scenarios()
FAILURE_SCENARIOS = [s for s in SCENARIOS if twl.scenario(s).failure_recipe is not None]


def _rows(trace):
    return [t.to_dict() for t in trace]


def _specs(specs):
    return [dataclasses.asdict(s) for s in specs]


def _events(events):
    return [e.to_dict() for e in events]


def test_same_public_names_and_registry():
    assert twl.__all__ == jwl.__all__
    assert SCENARIOS == jwl.list_scenarios()
    assert len(SCENARIOS) == 10
    assert twl.SCHEMA_VERSION == jwl.SCHEMA_VERSION
    assert twl.PRIORITY_CLASSES == jwl.PRIORITY_CLASSES
    for name in SCENARIOS:
        t, j = twl.scenario(name), jwl.scenario(name)
        assert (t.kind, t.default_num_jobs, t.heterogeneous, t.description) == (
            j.kind, j.default_num_jobs, j.heterogeneous, j.description)
        assert (t.failure_recipe is None) == (j.failure_recipe is None)
        if t.failure_recipe is not None:
            assert dataclasses.asdict(t.failure_recipe) == dataclasses.asdict(j.failure_recipe)


@pytest.mark.parametrize("num_jobs", [None, 100])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", SCENARIOS)
def test_make_trace_equals_jax(name, seed, num_jobs):
    """Field for field, through ``to_dict`` and JSON, and materialised into
    the simulator's job specs."""
    t = twl.scenario(name).make_trace(seed=seed, num_jobs=num_jobs)
    j = jwl.scenario(name).make_trace(seed=seed, num_jobs=num_jobs)
    assert len(t) == len(j) > 0
    assert json.dumps(_rows(t), sort_keys=True) == json.dumps(_rows(j), sort_keys=True)
    assert _specs(twl.to_jobspecs(t)) == _specs(jwl.to_jobspecs(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", FAILURE_SCENARIOS)
def test_make_failures_equals_jax(name, seed):
    """The failure stream on the scenario's own cluster, over the horizon
    the evaluation harness gives it, with the trace's job failures."""
    t_sc, j_sc = twl.scenario(name), jwl.scenario(name)
    rows_t, rows_j = t_sc.make_trace(seed=seed, num_jobs=100), j_sc.make_trace(seed=seed, num_jobs=100)
    horizon = max(r.arrival_s for r in rows_t) + 12 * 3600.0
    got = t_sc.make_failures(seed, t_sc.make_cluster(48), horizon, trace=rows_t)
    want = j_sc.make_failures(seed, j_sc.make_cluster(48), horizon, trace=rows_j)
    assert got and _events(got) == _events(want)


@pytest.mark.parametrize("num_gpus", [16, 48, 256])
@pytest.mark.parametrize("name", SCENARIOS)
def test_make_cluster_equals_jax(name, num_gpus):
    t = twl.scenario(name).make_cluster(num_gpus)
    j = jwl.scenario(name).make_cluster(num_gpus)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.is_heterogeneous == j.is_heterogeneous


@pytest.mark.parametrize("arrivals", [
    dict(kind="poisson", rate_per_hour=80.0),
    dict(kind="diurnal", rate_per_hour=60.0, peak_ratio=3.0, period_h=12.0),
    dict(kind="bursty", rate_per_hour=70.0),
    dict(kind="bursty", rate_per_hour=40.0, burst_size=9, burst_spread_s=60.0),
])
@pytest.mark.parametrize("durations", [
    dict(kind="lognormal", median_s=1800.0, sigma=1.6),
    dict(kind="pareto", median_s=900.0, alpha=1.1),
    dict(kind="loguniform", min_s=60.0, cap_s=36000.0),
])
def test_every_generator_kind_equals_jax(arrivals, durations):
    def recipe(wl):
        return wl.TraceRecipe(
            arrivals=wl.Arrivals(**arrivals),
            durations=wl.Durations(**durations),
            gangs=wl.GangSizes(sizes=(1, 2, 4, 8, 16), probs=(0.5, 0.2, 0.15, 0.1, 0.05)),
            models=("resnet50", "gpt3-xl", "dcgan"),
            production_fraction=0.2,
        )

    for seed in (0, 5):
        t = twl.generate_trace(recipe(twl), 150, seed)
        j = jwl.generate_trace(recipe(jwl), 150, seed)
        assert _rows(t) == _rows(j)


@pytest.mark.parametrize("axes", ["nodes", "gpus", "jobs", "all"])
def test_every_failure_axis_equals_jax(axes):
    def recipe(wl):
        full = wl.FailureRecipe(
            nodes=wl.NodeOutages(mtbf_h=2.0, max_per_node=3),
            gpus=wl.GpuDegradations(rate_per_node_per_day=6.0, factor_range=(0.2, 0.8)),
            jobs=wl.JobFailures(fail_prob=0.4, max_failures=3),
        )
        if axes == "all":
            return full
        return wl.FailureRecipe(**{axes: getattr(full, axes)})

    rows_t = twl.scenario("poisson-steady").make_trace(seed=3, num_jobs=60)
    rows_j = jwl.scenario("poisson-steady").make_trace(seed=3, num_jobs=60)
    got = twl.generate_failures(recipe(twl), ClusterSpec(6, 4), 20 * 3600.0, 3, trace=rows_t)
    want = jwl.generate_failures(recipe(jwl), JaxClusterSpec(6, 4), 20 * 3600.0, 3, trace=rows_j)
    assert got and _events(got) == _events(want)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_json_round_trip_across_packages(tmp_path, writer):
    """A v2 document (jobs and failures) written by one package is read by
    the other, field for field."""
    w, r = (jwl, twl) if writer == "jax" else (twl, jwl)
    sc = w.scenario("philly-failures")
    rows = sc.make_trace(seed=1, num_jobs=40)
    events = sc.make_failures(1, sc.make_cluster(48), 30 * 3600.0, trace=rows)
    path = tmp_path / "trace.json"
    w.save_json(str(path), rows, meta={"seed": 1}, failures=events)
    jobs, failures = r.load_json_with_failures(str(path))
    assert _rows(jobs) == _rows(rows) and _events(failures) == _events(events)
    assert _rows(r.load_json(str(path))) == _rows(rows)
    # v1 (no failures key) loads in both
    w.save_json(str(path), rows)
    assert r.load_json_with_failures(str(path))[1] == []


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_csv_round_trip_across_packages(tmp_path, writer):
    w, r = (jloaders, tloaders) if writer == "jax" else (tloaders, jloaders)
    rows = (jwl if writer == "jax" else twl).scenario("philly-like-burst").make_trace(
        seed=2, num_jobs=50)
    path = tmp_path / "philly.csv"
    w.save_philly_csv(str(path), rows)
    back = r.load_philly_csv(str(path))
    again = (tloaders if r is jloaders else jloaders).load_philly_csv(str(path))
    assert _rows(back) == _rows(again)
    assert [t.num_gpus for t in back] == [t.num_gpus for t in rows]
    assert [t.priority for t in back] == [t.priority for t in rows]


def test_csv_copies_are_byte_identical():
    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert tloaders.PHILLY_SAMPLE != jloaders.PHILLY_SAMPLE
    assert digest(tloaders.PHILLY_SAMPLE) == digest(jloaders.PHILLY_SAMPLE)
    assert _rows(tloaders.philly_sample()) == _rows(jloaders.philly_sample())


@pytest.mark.parametrize("tag", ["resnet50", "bert-large", "ResNet-101", "lstm", "", "x" * 40])
def test_unknown_model_tags_map_alike(tag):
    assert tloaders._canonical_model(tag) == jloaders._canonical_model(tag)


@pytest.mark.parametrize("fixture", ["shockwave_fixture", "gavel_fixture"])
def test_fixture_loaders_equal_jax(fixture):
    for seed in (0, 4):
        t = getattr(twl, fixture)(80, seed)
        j = getattr(jwl, fixture)(80, seed)
        assert _rows(t) == _rows(j)
        assert _specs(twl.to_jobspecs(t)) == _specs(jwl.to_jobspecs(j))


def test_schema_rejects_what_jax_rejects(tmp_path):
    with pytest.raises(ValueError, match="exactly one"):
        twl.JobTrace(job_id=0, model="resnet50", num_gpus=1, arrival_s=0.0)
    with pytest.raises(ValueError, match="priority"):
        twl.JobTrace(job_id=0, model="resnet50", num_gpus=1, arrival_s=0.0, duration_s=1.0,
                     priority="urgent")
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"schema": "tesserae-trace-v0", "jobs": []}))
    with pytest.raises(ValueError, match="schema"):
        twl.load_json(str(path))
    with pytest.raises(KeyError, match="unknown scenario"):
        twl.scenario("no-such-scenario")
    with pytest.raises(ValueError, match="already registered"):
        twl.register_scenario(twl.scenario("poisson-steady"))


def test_arrivals_are_sorted_and_seed_deterministic():
    for name in SCENARIOS:
        sc = twl.scenario(name)
        a = [t.arrival_s for t in sc.make_trace(seed=7, num_jobs=60)]
        assert a == sorted(a) or sc.kind != "synthetic"
        assert _rows(sc.make_trace(seed=7, num_jobs=60)) == _rows(sc.make_trace(seed=7, num_jobs=60))
    assert np.all(np.diff([t.arrival_s for t in twl.philly_sample()]) >= 0)
