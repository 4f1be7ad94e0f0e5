"""The slice as a whole: the port's Tesserae round against the JAX one.

``TesseraeScheduler.decide`` (cold, with ``prev_plan``, warm) and
``Simulator.run`` on small seeded traces go through both packages, the
port on ``device="cpu"``.  Plans, packings, migrations, matching costs,
degrade tags, per-round match stats and every job's completion time must
be identical.  Each port backend is held against the JAX backend of the
same name: the two auction bid paths differ on single-column instances
(``-1e30`` vs ``-1e18``, pinned in ``test_torch_auction.py``), in JAX as
in the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.cluster as jcl
import repro.core.faults as jfa
import repro.core.jobs as jjb
import repro.core.placement as jpl
import repro.core.policies as jpol
import repro.core.profiler as jprof
import repro.core.scheduler as jsch
import repro.core.simulator as jsim
import repro.core.traces as jtr
import repro.obs as jobs_
import repro_torch.core.cluster as tcl
import repro_torch.core.faults as tfa
import repro_torch.core.jobs as tjb
import repro_torch.core.placement as tpl
import repro_torch.core.policies as tpol
import repro_torch.core.profiler as tprof
import repro_torch.core.scheduler as tsch
import repro_torch.core.simulator as tsim
import repro_torch.core.traces as ttr
import repro_torch.obs as tobs
from tests.torch_spans import assert_reference_spans_equal, span_names

JAX = dict(cl=jcl, fa=jfa, jb=jjb, pl=jpl, pol=jpol, prof=jprof, sch=jsch, sim=jsim, tr=jtr, obs=jobs_, kw={})
TORCH = dict(
    cl=tcl, fa=tfa, jb=tjb, pl=tpl, pol=tpol, prof=tprof, sch=tsch, sim=tsim, tr=ttr, obs=tobs,
    kw={"device": "cpu"},
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run each test on one intra-op thread.  The port's tensors here are
    tiny, and under pytest-xdist every worker's default pool (one thread
    per core) spins against the other workers': measured on 8 cores with
    five busy neighbours, the shard-split tests of ``test_torch_fused.py``
    took 379 s with 8 threads and 9 s with one.  The other CPU
    ``test_torch_*`` files import this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scheduler(pkg, cluster, backend, policy="TiresiasPolicy", **kw):
    prof = pkg["prof"].ThroughputProfile()
    pol = getattr(pkg["pol"], policy)(prof)
    sched = pkg["sch"].TesseraeScheduler(
        cluster, pol, prof, lap_backend=backend, **kw, **pkg["kw"]
    )
    return sched, prof


def _assert_decisions_equal(dj, dt):
    np.testing.assert_array_equal(dj.plan.slots, dt.plan.slots)
    assert [j.job_id for j in dj.placed] == [j.job_id for j in dt.placed]
    assert [j.job_id for j in dj.pending] == [j.job_id for j in dt.pending]
    assert dj.packing.matches == dt.packing.matches
    assert dj.packing.strategies == dt.packing.strategies
    assert dj.packing.total_weight == dt.packing.total_weight
    assert dj.packing.num_edges == dt.packing.num_edges
    assert (dj.migration is None) == (dt.migration is None)
    if dj.migration is not None:
        assert dj.migration.num_migrations == dt.migration.num_migrations
        assert dj.migration.matching_cost == dt.migration.matching_cost
        np.testing.assert_array_equal(
            dj.migration.node_assignment, dt.migration.node_assignment
        )
    assert dj.degrade_reason == dt.degrade_reason
    assert dj.match_stats == dt.match_stats
    assert set(dj.timings) == set(dt.timings)


def _three_rounds(pkg, nodes, backend, num_jobs, **kw):
    cluster = pkg["cl"].ClusterSpec(nodes, 4)
    sched, prof = _scheduler(pkg, cluster, backend, obs=pkg["obs"].Observability(), **kw)
    jobs = pkg["tr"].synthetic_active_jobs(num_jobs, seed=1, profile=prof)
    d1 = sched.decide(jobs, now=0.0)
    d2 = sched.decide(jobs, now=360.0, prev_plan=d1.plan)
    churned = [j for j in jobs if j.job_id % 5 != 2]  # a few jobs finish
    d3 = sched.decide(churned, now=720.0, prev_plan=d2.plan)
    return [d1, d2, d3], sched.obs.tracer


THREE_ROUND_CASES = [
    ("auction", 3, 12, {}),
    ("auction", 2, 8, {"tie_break": True}),
    ("auction", 2, 10, {"migration_algorithm": "flat"}),
    ("auction_kernel", 2, 8, {}),
    ("scipy", 4, 24, {}),
]


@pytest.mark.parametrize("backend,nodes,num_jobs,kw", THREE_ROUND_CASES)
def test_decide_three_rounds_match_jax(backend, nodes, num_jobs, kw):
    dec_j, tr_j = _three_rounds(JAX, nodes, backend, num_jobs, **kw)
    dec_t, tr_t = _three_rounds(TORCH, nodes, backend, num_jobs, **kw)
    for dj, dt in zip(dec_j, dec_t):
        _assert_decisions_equal(dj, dt)
    # the obs span forests (names, nesting, attributes, order, tids) on the
    # reference's spans; the port's own stage spans are projected away
    assert_reference_spans_equal(tr_j.structure(), tr_t.structure())
    # the third round consulted the carried context
    assert dec_t[2].match_stats.get("solves", 0) > 0


@pytest.mark.parametrize("backend,nodes,num_jobs,kw", THREE_ROUND_CASES)
def test_decide_three_rounds_full_spans_repeat(backend, nodes, num_jobs, kw):
    """Two seeded port runs give the same full span forest, the port's own
    stage spans and their attributes included."""
    _, tr_a = _three_rounds(TORCH, nodes, backend, num_jobs, **kw)
    _, tr_b = _three_rounds(TORCH, nodes, backend, num_jobs, **kw)
    assert {"lap.prepare", "pack.graph", "migrate.cost"} <= span_names(tr_a.structure())
    assert tr_a.fingerprint() == tr_b.fingerprint()


def _make_sim(pkg, backend, num_jobs=8, failures=(), rate=80.0, sim=None, **kw):
    cluster = pkg["cl"].ClusterSpec(2, 4)
    sched, prof = _scheduler(pkg, cluster, backend, **kw)
    trace = pkg["tr"].shockwave_trace(
        num_jobs=num_jobs, arrival_rate_per_hour=rate, seed=3, profile=prof
    )
    if callable(failures):
        failures = failures(trace)
    events = [pkg["fa"].FailureEvent(*ev) for ev in failures]
    return pkg["sim"].Simulator(
        cluster, trace, sched, prof, pkg["sim"].SimConfig(**(sim or {})), failures=events
    )


def _sim(pkg, backend, stop_after=None, **kw):
    sim = _make_sim(pkg, backend, **kw)
    return sim, sim.run(stop_after_rounds=stop_after)


def _stepped_sim(pkg, backend, steps, path, **kw):
    """``steps`` calls of one round each, the state saved and loaded into a
    new simulator, ``steps`` more single rounds there, then the rest."""
    sim = _make_sim(pkg, backend, **kw)
    for _ in range(steps):
        assert sim.run(stop_after_rounds=1) is None
    sim.save_state(path)
    sim = _make_sim(pkg, backend, **kw)
    sim.load_state(path)
    for _ in range(steps):
        assert sim.run(stop_after_rounds=1) is None
    return sim.run()


def _assert_sim_equal(rj, rt):
    assert sorted(rj.jobs) == sorted(rt.jobs)
    for jid in rj.jobs:
        assert rj.jobs[jid].finish_time == rt.jobs[jid].finish_time, jid
    assert rj.avg_jct_s == rt.avg_jct_s
    assert rj.makespan_s == rt.makespan_s
    assert rj.num_rounds == rt.num_rounds
    assert rj.total_migrations == rt.total_migrations
    assert rj.match_rounds == rt.match_rounds
    assert rj.degrade_rounds == rt.degrade_rounds
    assert rj.preemptions == rt.preemptions
    assert rj.failed_jobs == rt.failed_jobs


def _assert_every_field_equal(rj, rt):
    """Every field of every job's state, its spec's too, and every field of
    the result that does not hold a wall time."""
    for jid, sj in rj.jobs.items():
        st = rt.jobs[jid]
        assert dataclasses.asdict(sj) == dataclasses.asdict(st), jid
    timed = {"overhead", "lp_refresh_s", "prewarm_wall_s", "prewarm_overlap_s", "metrics", "jobs"}
    for f in dataclasses.fields(rj):
        if f.name not in timed:
            assert getattr(rj, f.name) == getattr(rt, f.name), f.name
    assert rj.degrade_counts == rt.degrade_counts


_FAULTS = (
    (1500.0, "node-down", 1),
    (4000.0, "node-up", 1),
    (2500.0, "gpu-degrade", 0, None, 0.5),
)


def _sparse_faults(trace):
    """Faults over a trace most of whose jobs have finished or not arrived
    yet: every fourth job fails twice, 1.5 and 5.5 rounds after it
    arrives (backoff, then a retry budget of one running out where the
    second failure finds it running), and each node goes down for a while
    (evictions)."""
    rnd = 360.0
    events = []
    for s in trace[1::4]:
        events += [
            (s.arrival_time + 1.5 * rnd, "job-fail", None, s.job_id),
            (s.arrival_time + 5.5 * rnd, "job-fail", None, s.job_id),
        ]
    third = len(trace) // 3
    for node, t in ((1, trace[third].arrival_time), (0, trace[2 * third].arrival_time)):
        events += [(t, "node-down", node), (t + 6 * rnd, "node-up", node)]
    return tuple(events)


#: 32 jobs at 3 an hour on 8 GPUs (at most 6 live at once), paused round by
#: round for 67 rounds, saved on the boundary where node 0 goes down (so the
#: resumed run evicts from the rebuilt index first), then 67 more single rounds
_SPARSE = dict(num_jobs=32, rate=3.0, sim=dict(max_retries=1), steps=67)


@pytest.mark.parametrize(
    "backend,failures,kw",
    [
        ("auction", (), {}),
        ("auto", _FAULTS, {"health_aware": True}),
        pytest.param("auction", _sparse_faults, _SPARSE, id="sparse-live-faults-resumed"),
    ],
)
def test_simulator_run_matches_jax(backend, failures, kw, tmp_path):
    kw = dict(kw)
    steps = kw.pop("steps", None)
    _, rj = _sim(JAX, backend, failures=failures, **kw)
    if steps is None:
        _, rt = _sim(TORCH, backend, failures=failures, **kw)
    else:
        rt = _stepped_sim(
            TORCH, backend, steps, str(tmp_path / "sim.npz"), failures=failures, **kw
        )
        _assert_every_field_equal(rj, rt)
        # backoff, a retry budget running out and evictions all occurred
        assert rt.retries_total > len(rt.failed_jobs) > 0 and rt.preemptions > 0
        assert rt.num_rounds > 2 * steps
    _assert_sim_equal(rj, rt)
    assert rt.num_rounds > 3


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_simulator_state_file_resumes_across_packages(direction, tmp_path):
    """``save_state`` of one package, ``load_state`` in the other, and the
    resumed run finishes bit-identical to the uninterrupted one."""
    src, dst = (JAX, TORCH) if direction == "jax_to_torch" else (TORCH, JAX)
    _, full = _sim(src, "auction")
    paused, _ = _sim(src, "auction", stop_after=4)
    path = str(tmp_path / "sim.npz")
    paused.save_state(path)
    resumed_sim = _make_sim(dst, "auction")
    resumed_sim.load_state(path)
    _assert_sim_equal(full, resumed_sim.run())


def test_speculative_prewarm_and_invalidate_node_match_jax():
    runs = []
    for pkg in (JAX, TORCH):
        cluster = pkg["cl"].ClusterSpec(2, 4)
        sched, prof = _scheduler(pkg, cluster, "auction")
        trace = pkg["tr"].shockwave_trace(num_jobs=6, seed=5, profile=prof)
        cfg = pkg["sim"].SimConfig(speculative_prewarm=True)
        res = pkg["sim"].Simulator(cluster, trace, sched, prof, cfg).run()
        runs.append((res, sched.invalidate_node(1)))
    (rj, nj), (rt, nt) = runs
    assert nj == nt > 0
    assert sorted(rj.jcts) == sorted(rt.jcts)
    assert rj.total_migrations == rt.total_migrations


@pytest.mark.parametrize(
    "policy",
    ["FifoPolicy", "SrtfPolicy", "TiresiasPolicy", "ThemisFtfPolicy", "GavelPolicy", "PopPolicy"],
)
def test_policy_order_and_placement_match_jax(policy):
    """Host substrate: policy priority order and greedy placement on a
    heterogeneous, racked cluster with a down node, with and without
    ``type_affinity`` and ``spread_domains``."""
    out = []
    for pkg in (JAX, TORCH):
        prof = pkg["prof"].ThroughputProfile()
        cluster = pkg["cl"].ClusterSpec(
            4, 4, node_gpu_types=("a100", "a100", "v100", "v100"), nodes_per_rack=2
        )
        pol = getattr(pkg["pol"], policy)(prof)
        jobs = pkg["tr"].synthetic_active_jobs(20, seed=4, profile=prof)
        if hasattr(pol, "refresh"):
            pol.refresh(jobs, cluster)
        ordered = pol.order(jobs, 100.0, cluster)
        placements = []
        for affinity in (True, False):
            for spread in (False, True):
                plan, placed, pending = pkg["pl"].place_without_packing(
                    cluster, ordered, type_affinity=affinity, down_nodes=[1],
                    spread_domains=spread,
                )
                placements.append(
                    (plan.slots.tolist(), [j.job_id for j in placed], [j.job_id for j in pending])
                )
        out.append(([j.job_id for j in ordered], placements))
    assert out[0] == out[1]


def _churn_replay(pkg, backend, tie_break, shadow_backend=None):
    """The 60+-round churn replay of ``tests/test_churn_replay.py`` (Poisson
    arrivals, completions and Tiresias demotion-resume on 16 GPUs), with an
    optional cold shadow scheduler deciding every round from the same
    inputs first."""
    prof = pkg["prof"].ThroughputProfile()
    cluster = pkg["cl"].ClusterSpec(4, 4)

    def make(b):
        return pkg["sch"].TesseraeScheduler(
            cluster, pkg["pol"].TiresiasPolicy(prof, queue_base=900.0), prof,
            lap_backend=b, enable_packing=False, tie_break=tie_break, **pkg["kw"],
        )

    sched, shadow = make(backend), (make(shadow_backend) if shadow_backend else None)
    log = []
    inner = sched.decide

    def decide(active, now, prev_plan=None, num_gpus_of=None):
        want = None
        if shadow is not None:
            shadow.match_context.reset()
            want = shadow.decide(active, now, prev_plan, num_gpus_of).plan.slots.copy()
        d = inner(active, now, prev_plan, num_gpus_of)
        log.append((d.plan.slots.copy(), want, d.match_stats))
        return d

    sched.decide = decide
    trace = pkg["tr"].shockwave_trace(
        num_jobs=28, arrival_rate_per_hour=220.0, seed=5, profile=prof
    )
    cfg = pkg["sim"].SimConfig(round_duration_s=360.0, resume_fraction=0.25)
    return pkg["sim"].Simulator(cluster, trace, sched, prof, cfg).run(), log


def test_churn_replay_tie_break_auction_equals_scipy_and_jax():
    """With tie-breaking, the port's warm auction replay is bit-for-bit its
    own cold scipy shadow in every round (the JAX package's
    ``TestTieBreakDifferential`` contract), and its JCTs equal the JAX
    package's scipy replay."""
    res_t, log = _churn_replay(TORCH, "auction", True, shadow_backend="scipy")
    assert len(log) >= 30
    for t, (plan, shadow_plan, stats) in enumerate(log):
        np.testing.assert_array_equal(plan, shadow_plan, err_msg=f"round {t}")
    assert sum(s.get("warm_instances", 0) > 0 for _, _, s in log) > len(log) // 2
    res_j, _ = _churn_replay(JAX, "scipy", True)
    assert sorted(res_j.jobs) == sorted(res_t.jobs)
    for jid in res_j.jobs:
        assert res_j.jobs[jid].finish_time == res_t.jobs[jid].finish_time, jid
    assert res_j.makespan_s == res_t.makespan_s


@pytest.mark.parametrize("seed", [3, 7])
def test_chaos_sequences_match_jax(seed):
    """Seeded chaos sequences of ``tests/test_faults.py`` (node outages,
    GPU degradations, job failures, retries with backoff, checkpoint
    rollback) through both simulators with the auction backend: every
    job's outcome, the degrade tags and the preemptions are identical."""
    from repro.core.traces import TABLE1_MODELS
    from repro.workloads.failures import (
        FailureRecipe, GpuDegradations, NodeOutages, generate_failures,
    )

    rnd = 360.0
    prof = jprof.ThroughputProfile()
    rng = np.random.default_rng([seed, 0xC4A05])
    specs = []
    for i in range(5 + seed % 4):
        model = TABLE1_MODELS[int(rng.integers(len(TABLE1_MODELS)))]
        gpus = int(rng.choice([1, 1, 2, 4]))
        rounds = 2 + int(rng.integers(6))
        specs.append(dict(
            job_id=i, model=model, num_gpus=gpus,
            total_iters=prof.isolated(model, gpus, "dp") * rnd * rounds,
            arrival_time=float(rng.integers(0, 6)) * rnd,
        ))
    events = generate_failures(
        FailureRecipe(
            nodes=NodeOutages(mtbf_h=0.3 + 0.2 * (seed % 4), repair_median_s=600.0,
                              repair_sigma=0.5),
            gpus=GpuDegradations(rate_per_node_per_day=24.0) if seed % 3 == 0 else None,
        ),
        jcl.ClusterSpec(2 + seed % 3, 4), 40 * rnd, seed,
    )
    rng = np.random.default_rng([seed, 0xC4A06])
    for s in specs:
        if rng.random() < 0.3:
            events.append(jfa.FailureEvent(
                s["arrival_time"] + float(rng.uniform(0, 8 * rnd)), jfa.JOB_FAIL,
                job_id=s["job_id"],
            ))
    events.sort(key=jfa.FailureEvent.sort_key)
    assert events

    outcomes = []
    for pkg in (JAX, TORCH):
        cluster = pkg["cl"].ClusterSpec(2 + seed % 3, 4)
        sched, p = _scheduler(pkg, cluster, "auction", health_aware=seed % 2 == 1)
        cfg = pkg["sim"].SimConfig(
            max_time_s=200 * rnd, max_retries=3, backoff_base_s=rnd,
            checkpoint_interval_s=2 * rnd,
        )
        evs = [pkg["fa"].FailureEvent.from_dict(e.to_dict()) for e in events]
        res = pkg["sim"].Simulator(
            cluster, [pkg["jb"].JobSpec(**s) for s in specs], sched, p, cfg, failures=evs
        ).run()
        outcomes.append({
            "jobs": {
                jid: (s.finish_time, s.iters_done, s.migrations, s.retries, s.failed)
                for jid, s in res.jobs.items()
            },
            "makespan": res.makespan_s, "migrations": res.total_migrations,
            "rounds": res.num_rounds, "degrade": tuple(res.degrade_rounds),
            "preemptions": res.preemptions, "applied": res.fault_events_applied,
            "match_rounds": res.match_rounds,
        })
    assert outcomes[0] == outcomes[1]
    assert outcomes[1]["applied"] > 0
