"""The port's fused migrate stage against the JAX package's.

``core/fused.py`` (``FusedMigrationPlanner`` and its pieces) and
``TesseraeScheduler(fused_fanout=True)`` go through both packages on the same
inputs, the port on ``device="cpu"`` and JAX on the CPU as its own tests run
it.  Plans, node assignments, matching costs, every ``stats`` delta, degrade
tags, the obs span forests and every job's completion time must be
identical.  The planner's pair-axis split (``shards``) must not change any
of them.  The fused kernel's plain version is held against the Pallas
kernels in ``test_torch_kernels.py``; the kernel itself runs only on the
card (``test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fused as jfu
import repro_torch.core.fused as tfu
from repro.core.traces import TABLE1_MODELS
from repro_torch.core.matching import auction as tauction
from tests.test_torch_round import (  # noqa: F401  (_one_torch_thread: autouse)
    JAX,
    TORCH,
    _assert_sim_equal,
    _one_torch_thread,
)
from tests.torch_spans import assert_reference_spans_equal, span_names

JAX = dict(JAX, fu=jfu)
TORCH = dict(TORCH, fu=tfu)

ROUND = 360.0


def _plans(pkg, nodes, kl, seed, drop, num_jobs=12):
    """(prev, new_logical, num_gpus_of) from the package's own placement."""
    prof = pkg["prof"].ThroughputProfile()
    cluster = pkg["cl"].ClusterSpec(nodes, kl)
    jobs = pkg["tr"].synthetic_active_jobs(num_jobs, seed=seed, profile=prof)
    jobs = [j for j in jobs if j.num_gpus <= kl or j.num_gpus % kl == 0]
    prev, _, _ = pkg["pl"].place_without_packing(cluster, jobs)
    new, _, _ = pkg["pl"].place_without_packing(cluster, jobs[drop:] or jobs)
    return prev, new, {j.job_id: j.num_gpus for j in jobs}


def _result(res, planner, before):
    return (
        res.physical_plan.slots.tolist(),
        None if res.node_assignment is None else res.node_assignment.tolist(),
        res.matching_cost,
        res.num_migrations,
        res.algorithm,
        planner.last_fallback_reason,
        {k: planner.stats[k] - before[k] for k in planner.stats},
    )


def _planner_steps(pkg, tie_break, speed=None, shards=1, use_kernel=False):
    """cold -> steady -> a changed new plan -> invalidate_nodes([1]) -> two
    recovery rounds -> a fresh planner on the same inputs."""
    prev, new, g = _plans(pkg, 4, 4, seed=11, drop=0)
    _, new2, _ = _plans(pkg, 4, 4, seed=11, drop=3)
    def mk():
        return pkg["fu"].FusedMigrationPlanner(shards=shards, use_kernel=use_kernel, **pkg["kw"])

    planner = mk()
    out = []

    def step(p, n, pl=planner):
        before = dict(pl.stats)
        res = pl.plan(p, n, g, tie_break=tie_break, speed_factor=speed)
        out.append(_result(res, pl, before))

    step(prev, new)
    step(prev, new)
    step(prev, new2)
    planner.invalidate_nodes([1])
    step(prev, new2)
    step(prev, new2)
    step(prev, new2, mk())
    return out


# --------------------------------------------------------------------------- #
# pieces of the program
# --------------------------------------------------------------------------- #
def test_pair_costs_match_jax_bitwise_with_empty_slots():
    rng = np.random.default_rng(0)
    kc, kl, p = 3, 4, 2
    pi = rng.integers(0, 9, size=(kc, kl, p))
    pj = rng.integers(0, 9, size=(kc, kl, p))
    pi[rng.random(pi.shape) < 0.3] = -1
    pj[rng.random(pj.shape) < 0.3] = -1
    pi[1, 2, :] = -1  # a fully empty GPU on each side
    pj[0, 3, :] = -1
    for weights in (
        np.append(rng.choice([8.0, 4.0, 2.0, 1.0], 9), [0.0, 0.0]).astype(np.float32),
        np.append(rng.normal(size=9), [0.0, 0.0]).astype(np.float32),  # order matters
    ):
        want = jfu._pair_costs(
            jnp.asarray(pi, jnp.int32), jnp.asarray(pj, jnp.int32), jnp.asarray(weights)
        )
        got = tfu._pair_costs(torch.from_numpy(pi), torch.from_numpy(pj), torch.from_numpy(weights))
        assert got.shape == (kc, kc, kl, kl)
        np.testing.assert_array_equal(np.asarray(want).view(np.int32), got.numpy().view(np.int32))
    # an EMPTY slot weighs 0 whatever the weight table's first entry is
    only_empty = torch.full((1, 1, p), -1)
    w = torch.tensor([5.0, 0.0])
    assert tfu._pair_costs(only_empty, only_empty, w).abs().sum() == 0


def test_tb_scale_and_ramp_match_jax():
    for n, m in [(4, 4), (8, 8), (512, 512), (1, 1)]:
        assert tfu._tb_scale(n, m) == jfu._tb_scale(n, m)
    np.testing.assert_array_equal(
        np.asarray(jfu._ramp(5, 7)), tfu._ramp(5, 7, "cpu").numpy()
    )


def test_warm_complete_instance_stops_with_zero_bid_rounds():
    """``_auction_square`` with an explicit complete ``init_col_of`` on a
    warm instance runs no bid round (the clean-pair fast path); a cold one
    from the same start still runs its schedule."""
    cost = torch.tensor([[[0.0, 4.0], [4.0, 0.0]], [[0.0, 4.0], [4.0, 0.0]]])
    col, prices, iters, conv = tfu._pair_auction(
        cost, 1 / 3, torch.zeros(2, 2), torch.tensor([[0, 1], [0, 1]]),
        torch.tensor([True, False]), 100, False, 0.0,
    )
    assert iters.tolist()[0] == 0 and iters.tolist()[1] > 0
    assert conv.all() and col.tolist() == [[0, 1], [0, 1]]


# --------------------------------------------------------------------------- #
# the planner
# --------------------------------------------------------------------------- #
SPEED = np.array([1.0, 0.6, 1.0, 0.3])


@pytest.mark.parametrize(
    "tie_break,speed", [(False, None), (True, None), (True, SPEED)],
    ids=["plain", "tie_break", "tie_break+speed"],
)
def test_planner_sequence_matches_jax(tie_break, speed):
    want = _planner_steps(JAX, tie_break, speed)
    got = _planner_steps(TORCH, tie_break, speed)
    assert got == want
    stats = [s[-1] for s in got]
    assert stats[0]["fused_dirty_pairs"] == 16  # cold: every pair
    assert stats[1]["fused_dirty_pairs"] == 0 and stats[1]["fused_readouts"] == 1
    assert stats[3]["fused_dirty_pairs"] > 0  # the poisoned rows re-solve
    assert stats[4]["fused_dirty_pairs"] == 0 and stats[4]["fused_readouts"] == 1
    assert all(s["fused_host_fallbacks"] == 0 for s in stats)
    # the recovered plan is a fresh planner's (without tie-breaking, equally
    # optimal plans may differ between a warm and a cold solve; costs not)
    assert got[4][2] == got[5][2]
    if tie_break:
        assert got[4][:4] == got[5][:4]


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_shard_split_changes_nothing(shards):
    """Splitting the pair axis into chunks is partitioning, never semantics:
    every plan and every stats delta equals the unsplit JAX planner's."""
    assert _planner_steps(TORCH, True, shards=shards) == _planner_steps(JAX, True, shards=1)


def test_use_kernel_on_cpu_matches_jax_kernel_path():
    """``use_kernel=True`` on CPU tensors takes the fused kernel's plain
    version; it equals JAX's planner on the Pallas kernel (interpret
    mode), and both equal the plain top-2 path on these multi-column
    instances."""
    got = _planner_steps(TORCH, True, use_kernel=True)
    assert got == _planner_steps(JAX, True, use_kernel=True)
    assert got == _planner_steps(TORCH, True, use_kernel=False)


def test_nonconverged_round_falls_back_like_jax():
    """An auction cut off by ``max_iters`` sends the round to the host
    planner (``fused-nonconverged``) and drops the device cache; its -1
    indices are clamped before every gather, so the round gets there."""
    out = []
    for pkg in (JAX, TORCH):
        prev, new, g = _plans(pkg, 4, 4, seed=11, drop=3)
        planner = pkg["fu"].FusedMigrationPlanner(max_iters=3, **pkg["kw"])
        steps = []
        for _ in range(2):
            before = dict(planner.stats)
            res = planner.plan(prev, new, g, tie_break=True)
            steps.append(_result(res, planner, before))
            assert planner._cache is None
        out.append(steps)
    assert out[0] == out[1]
    assert out[1][0][4:6] == ("node-fused-fallback", "fused-nonconverged")
    assert out[1][1][-1]["fused_nonconverged_fallbacks"] == 1


def test_single_column_pairs_differ_between_bid_paths():
    """With one GPU per node every pair instance is 1x1: the kernel's "no
    second column" value is -1e30, the plain top-2's -1e18, so the cached
    pair prices differ between the two paths — in JAX as in the port (D2).
    Plans agree."""
    runs = {}
    for name, pkg in (("jax", JAX), ("torch", TORCH)):
        prev, new, g = _plans(pkg, 3, 1, seed=3, drop=1, num_jobs=6)
        for uk in (False, True):
            planner = pkg["fu"].FusedMigrationPlanner(use_kernel=uk, **pkg["kw"])
            res = planner.plan(prev, new, g)
            prices = np.asarray(planner._cache[3])
            runs[name, uk] = (res.physical_plan.slots.tolist(), prices)
    for uk in (False, True):
        assert runs["jax", uk][0] == runs["torch", uk][0]
        np.testing.assert_array_equal(runs["jax", uk][1], runs["torch", uk][1])
    assert runs["torch", False][0] == runs["torch", True][0]
    assert (runs["torch", False][1] == np.float32(1e18)).all()
    assert (runs["torch", True][1] == np.float32(1e30)).all()


def test_fused_round_reads_the_host_only_through_the_loop_flag(monkeypatch):
    """Inside ``_fused_round`` the only device->host reads are the auction
    loop's ``any(active)`` flags, counted in ``auction.loop_syncs``; the
    planner's one readout comes after it."""
    prev, new, g = _plans(TORCH, 4, 4, seed=11, drop=2)
    planner = tfu.FusedMigrationPlanner(shards=3, device="cpu")
    inner = tfu._fused_round
    reads = {"bool": 0}

    def forbidden(name):
        def fail(*a, **k):
            raise AssertionError(f"host read {name} inside _fused_round")
        return fail

    def counted_bool(t):
        reads["bool"] += 1
        return orig_bool(t)

    orig_bool = torch.Tensor.__bool__

    def guarded(*a, **k):
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__"):
                m.setattr(torch.Tensor, name, forbidden(name))
            m.setattr(torch.Tensor, "__bool__", counted_bool)
            s0, r0 = tauction.loop_syncs.count, reads["bool"]
            out = inner(*a, **k)
            assert reads["bool"] - r0 == tauction.loop_syncs.count - s0 > 0
        return out

    monkeypatch.setattr(tfu, "_fused_round", guarded)
    for _ in range(2):
        before = dict(planner.stats)
        planner.plan(prev, new, g, tie_break=True)
        assert planner.stats["fused_readouts"] - before["fused_readouts"] == 1
    assert planner.stats["fused_rounds"] == 2


# --------------------------------------------------------------------------- #
# through the scheduler
# --------------------------------------------------------------------------- #
def _fused_churn_replay(pkg, tie_break, shards):
    """The churn replay of ``tests/test_fused_decide.py`` (Poisson arrivals,
    completions and Tiresias demotion-resume on 16 GPUs, 60+ rounds) with
    ``fused_fanout=True``, logging every round's decision and obs span
    forest."""
    prof = pkg["prof"].ThroughputProfile()
    cluster = pkg["cl"].ClusterSpec(4, 4)
    sched = pkg["sch"].TesseraeScheduler(
        cluster, pkg["pol"].TiresiasPolicy(prof, queue_base=900.0), prof,
        lap_backend="scipy", enable_packing=False, tie_break=tie_break,
        fused_fanout=True, fanout_shards=shards, obs=pkg["obs"].Observability(),
        **pkg["kw"],
    )
    log = []
    inner = sched.decide

    def decide(active, now, prev_plan=None, num_gpus_of=None, health=None):
        d = inner(active, now, prev_plan, num_gpus_of, health)
        mig = d.migration
        log.append((
            d.plan.slots.tolist(),
            None if mig is None else (mig.matching_cost, mig.num_migrations, mig.algorithm,
                                      None if mig.node_assignment is None
                                      else mig.node_assignment.tolist()),
            d.match_stats, d.degrade_reason, sched.obs.tracer.structure(),
        ))
        return d

    sched.decide = decide
    trace = pkg["tr"].shockwave_trace(
        num_jobs=28, arrival_rate_per_hour=220.0, seed=5, profile=prof
    )
    cfg = pkg["sim"].SimConfig(round_duration_s=ROUND, resume_fraction=0.25)
    return pkg["sim"].Simulator(cluster, trace, sched, prof, cfg).run(), log


@pytest.mark.parametrize("tie_break,shards", [(True, 1), (False, 8)])
def test_fused_churn_replay_matches_jax(tie_break, shards):
    res_j, log_j = _fused_churn_replay(JAX, tie_break, shards)
    res_t, log_t = _fused_churn_replay(TORCH, tie_break, shards)
    assert len(log_t) >= 30
    # each round's span forest on the reference's spans (those of its whole
    # run); the port's own stage spans are projected away
    names = span_names(log_j[-1][4])
    for t, (lj, lt) in enumerate(zip(log_j, log_t)):
        assert lj[:4] == lt[:4], f"round {t}"
        assert_reference_spans_equal(lj[4], lt[4], names)
    assert len(log_j) == len(log_t)
    _assert_sim_equal(res_j, res_t)
    stats = [entry[2] for entry in log_t]
    mig_rounds = sum(1 for entry in log_t if entry[1] is not None)
    assert sum(s.get("fused_rounds", 0) for s in stats) == mig_rounds
    assert sum(s.get("fused_readouts", 0) for s in stats) == mig_rounds
    assert sum(s.get("fused_host_fallbacks", 0) for s in stats) == 0
    partial = sum(
        1 for s in stats
        if s.get("fused_pair_instances")
        and s.get("fused_dirty_pairs", 0) < s["fused_pair_instances"]
    )
    assert partial >= mig_rounds // 2


def _tiny_specs(num_jobs, seed, max_rounds=6):
    """``tests/test_faults.py``'s ``_tiny_trace`` as plain dicts, so each
    package builds its own ``JobSpec``s from the same numbers."""
    prof = JAX["prof"].ThroughputProfile()
    rng = np.random.default_rng([seed, 0xC4A05])
    specs = []
    for i in range(num_jobs):
        model = TABLE1_MODELS[int(rng.integers(len(TABLE1_MODELS)))]
        gpus = int(rng.choice([1, 1, 2, 4]))
        rate = prof.isolated(model, gpus, "dp")
        rounds = 2 + int(rng.integers(max_rounds))
        specs.append(dict(
            job_id=i, model=model, num_gpus=gpus, total_iters=rate * ROUND * rounds,
            arrival_time=float(rng.integers(0, 6)) * ROUND,
        ))
    return specs


def _fault_scheduler(pkg, nodes, **kw):
    prof = pkg["prof"].ThroughputProfile()
    kw.setdefault("lap_backend", "numpy")
    return pkg["sch"].TesseraeScheduler(
        pkg["cl"].ClusterSpec(nodes, 4), pkg["pol"].TiresiasPolicy(prof), prof,
        migration_algorithm="node", **kw, **pkg["kw"],
    ), prof


def _states(pkg, specs):
    return [pkg["jb"].JobState(spec=pkg["jb"].JobSpec(**s)) for s in specs]


def _scripted_clock(values):
    it = iter(values)
    last = [0.0]

    def clock():
        last[0] = next(it, last[0])
        return last[0]

    return clock


def test_forced_budget_fallback_matches_jax(monkeypatch):
    """``_F32_MANTISSA = 0`` sends every fused round to the host planner
    (``fused-budget``): the same plans as the host path, in both packages,
    and a simulator that counts the fallbacks alike."""
    monkeypatch.setattr(jfu, "_F32_MANTISSA", 0.0)
    monkeypatch.setattr(tfu, "_F32_MANTISSA", 0.0)
    specs = _tiny_specs(10, seed=5)
    out = []
    for pkg in (JAX, TORCH):
        host, _ = _fault_scheduler(pkg, 3)
        states = _states(pkg, specs)
        dh = host.decide(states, ROUND, host.decide(states, 0.0).plan)
        fused, _ = _fault_scheduler(pkg, 3, fused_fanout=True)
        df = fused.decide(states, ROUND, fused.decide(states, 0.0).plan)
        assert df.degrade_reason == pkg["sch"].DegradeReason.FUSED_BUDGET
        assert np.array_equal(df.plan.slots, dh.plan.slots)
        assert df.match_stats.get("fused_host_fallbacks", 0) >= 1
        sched, prof = _fault_scheduler(pkg, 2, fused_fanout=True)
        cluster = sched.cluster
        trace = [pkg["jb"].JobSpec(**s) for s in _tiny_specs(6, seed=6)]
        res = pkg["sim"].Simulator(cluster, trace, sched, prof, pkg["sim"].SimConfig()).run()
        assert res.fused_host_fallbacks > 0
        out.append((df.plan.slots.tolist(), df.match_stats, fused._fused_planner.stats,
                    res.fused_host_fallbacks, dict(res.degrade_counts), res.avg_jct_s))
    assert out[0] == out[1]


def test_deadline_host_demotion_matches_jax():
    specs = _tiny_specs(10, seed=9)
    out = []
    for pkg in (JAX, TORCH):
        base, _ = _fault_scheduler(pkg, 3)
        states = _states(pkg, specs)
        d0 = base.decide(states, 0.0)
        dh = base.decide(states, ROUND, d0.plan)
        fused, _ = _fault_scheduler(
            pkg, 3, fused_fanout=True, decide_deadline_s=1.0,
            clock=_scripted_clock([0.0, 0.7]),
        )
        df = fused.decide(states, ROUND, d0.plan)
        assert df.degrade_reason == pkg["sch"].DegradeReason.DEADLINE_HOST
        assert np.array_equal(df.plan.slots, dh.plan.slots)
        assert fused._fused_planner is None  # demoted before the planner was built
        out.append((df.plan.slots.tolist(), df.match_stats, df.degrade_reason))
    assert out[0] == out[1]


def test_fused_health_terms_match_jax():
    """The port of ``test_faults.py``'s fused health-term parity: six rounds
    with a moving straggler, fused vs host within each package and fused
    vs fused across them."""
    specs = _tiny_specs(10, seed=17)
    out = []
    for pkg in (JAX, TORCH):
        host, _ = _fault_scheduler(pkg, 3, health_aware=True, tie_break=True)
        fused, _ = _fault_scheduler(pkg, 3, health_aware=True, tie_break=True, fused_fanout=True)
        sh, sf = _states(pkg, specs), _states(pkg, specs)
        health = pkg["cl"].ClusterHealth(3)
        health.speed_factor[1] = 0.6
        health.note_outage()
        ph = pf = None
        rounds = []
        for rnd in range(6):
            if rnd == 3:
                health.speed_factor[1] = 1.0
                health.speed_factor[2] = 0.3
                for n in (1, 2):
                    host.invalidate_node(n)
                    fused.invalidate_node(n)
            for i, (x, y) in enumerate(zip(sh, sf)):
                bump = 137.0 * ((i + rnd) % 5)
                x.attained_service += bump
                y.attained_service += bump
            dh = host.decide(sh, rnd * ROUND, ph, health=health)
            df = fused.decide(sf, rnd * ROUND, pf, health=health)
            assert np.array_equal(dh.plan.slots, df.plan.slots), f"round {rnd}"
            ph, pf = dh.plan, df.plan
            rounds.append((df.plan.slots.tolist(), df.match_stats))
        assert fused._fused_planner.stats["fused_budget_fallbacks"] == 0
        out.append(rounds)
    assert out[0] == out[1]


def _fused_sim(pkg, failures):
    specs = _tiny_specs(12, seed=11, max_rounds=8)
    sched, prof = _fault_scheduler(pkg, 3, fused_fanout=True, tie_break=True)
    cfg = pkg["sim"].SimConfig(max_retries=3, backoff_base_s=ROUND)
    evs = [pkg["fa"].FailureEvent(*ev) for ev in failures]
    return pkg["sim"].Simulator(
        sched.cluster, [pkg["jb"].JobSpec(**s) for s in specs], sched, prof, cfg, failures=evs
    )


_RESUME_FAULTS = (
    (2 * ROUND, "node-down", 1),
    (5 * ROUND, "node-up", 1),
    (3 * ROUND, "gpu-degrade", 0, None, 0.5),
)


@pytest.mark.parametrize("kill_after", [2, 4])
def test_fused_crash_resume_is_bit_identical(tmp_path, kill_after):
    """A fused run paused, saved, loaded into a fresh simulator and resumed
    (the device cache is dropped on load) finishes bit-identical to an
    uninterrupted run — and to the JAX package's."""
    full = _fused_sim(TORCH, _RESUME_FAULTS).run()
    victim = _fused_sim(TORCH, _RESUME_FAULTS)
    assert victim.run(stop_after_rounds=kill_after) is None
    assert victim.scheduler._fused_planner is not None
    path = str(tmp_path / "snap.npz")
    victim.save_state(path)
    resumed = _fused_sim(TORCH, _RESUME_FAULTS)
    resumed.run(stop_after_rounds=3)  # build a planner with a live cache ...
    resumed.load_state(path)  # ... which the load must drop
    assert resumed.scheduler._fused_planner._cache is None
    res = resumed.run()
    # the resumed run's first fused round re-solves every pair (cold cache),
    # so only the bid counters may differ from the uninterrupted run's
    assert _outcome(res) == _outcome(full)
    assert res.fused_host_fallbacks == 0
    jax_full = _fused_sim(JAX, _RESUME_FAULTS).run()
    _assert_sim_equal(jax_full, full)


def _outcome(res):
    """The decision-relevant outcome of a run (``test_faults.py``'s
    ``_fingerprint``)."""
    return {
        "jobs": {
            jid: (s.finish_time, s.iters_done, s.migrations, s.retries, s.failed)
            for jid, s in res.jobs.items()
        },
        "makespan": res.makespan_s,
        "migrations": res.total_migrations,
        "rounds": res.num_rounds,
        "degrade": tuple(res.degrade_rounds),
        "preemptions": res.preemptions,
    }
