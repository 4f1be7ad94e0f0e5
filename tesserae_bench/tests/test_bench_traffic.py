"""The generator: deterministic in the seed, the same jobs for every seed,
the warm-up's jobs shared, and each traffic file's stationarity band."""

import copy
from collections import Counter

import numpy as np
import pytest

from tesserae_bench import harness, traffic

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


def _mix(cell):
    return harness.resolve(harness.load_manifest(), cell)[2]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_jobs_and_every_seed_the_same_set(cell):
    mix = _mix(cell)
    a = traffic.make_trace(mix, 32, 2**31 + 5, 360.0)
    b = traffic.make_trace(mix, 32, 2**31 + 5, 360.0)
    c = traffic.make_trace(mix, 32, 11, 360.0)
    assert a == b
    assert [j.arrival_s for j in a] == [j.arrival_s for j in c]

    def attrs(jobs):
        return Counter((j.model, j.num_gpus, j.duration_s, j.batch_size, j.packable) for j in jobs)

    assert attrs(a) == attrs(c) and a != c
    warm = mix["warmup_rounds"] * 360.0
    assert [j for j in a if j.arrival_s < warm] == [j for j in c if j.arrival_s < warm]


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_files_name_their_parameters(cell):
    mix = _mix(cell)
    for key in ("base_seed", "initial_jobs_per_gpu", "arrivals", "durations", "gangs", "models",
                "warmup_rounds", "live_rounds", "trace_rounds", "reference_rounds", "band"):
        assert key in mix, key
    assert 0 < mix["live_rounds"] < mix["warmup_rounds"] < mix["trace_rounds"]
    assert abs(sum(mix["gangs"]["probs"]) - 1.0) < 1e-9


def test_arrival_processes_keep_their_rate():
    rng = np.random.default_rng(0)
    for spec in ({"kind": "poisson"}, {"kind": "bursty", "burst_every_h": 0.5, "burst_spread_s": 300.0}):
        t = traffic.arrival_times(spec, 100.0, 400 * 3600.0, rng)
        assert np.all(np.diff(t) >= 0) and t[-1] < 400 * 3600.0
        assert abs(t.size / 400 - 100.0) < 5.0


@pytest.mark.parametrize("cell", CELLS)
def test_stationarity_band_at_a_tiny_cluster(cell):
    """After the warm-up, the active jobs, pending jobs and GPUs placed per
    GPU stay inside the band the traffic file records (``band.tiny``), at
    the file's tiny cluster, on the CPU's exact host solvers."""
    import torch

    manifest = harness.load_manifest()
    w, config, mix = harness.resolve(manifest, cell)
    band = mix["band"]["tiny"]
    config = copy.deepcopy(config)
    config["cluster"]["num_nodes"] = band["nodes"]
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
