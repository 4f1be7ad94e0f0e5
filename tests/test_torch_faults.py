"""The 200-seed chaos bulk of ``tests/test_faults.py`` through the port.

The same seeded failure sequences (node outages, GPU degradations, job
failures) drive ``repro_torch``'s simulator on the CPU, and the same
per-round safety invariants are asserted through its ``round_hook``:
gangs stay intact, nothing is placed on a down node or before its backoff
expired, per-GPU capacity holds, retry budgets are bounded, the realised
backoff schedule is geometric and no job is lost.  The failure events are
generated twice: by the JAX package's ``repro.workloads.failures``, handed
over through their dict form, and by the port's own
``repro_torch.workloads.failures``, whose events must equal them.
"""

import numpy as np
import pytest

from repro.core.cluster import ClusterSpec as JaxClusterSpec
from repro.core.faults import JOB_FAIL
from repro.core.faults import FailureEvent as JaxFailureEvent
from repro.workloads import failures as jax_failures
from repro_torch.core.cluster import MAX_PACK, ClusterSpec
from repro_torch.core.faults import FailureEvent
from repro_torch.core.jobs import JobSpec
from repro_torch.core.policies import TiresiasPolicy
from repro_torch.core.profiler import ThroughputProfile
from repro_torch.core.scheduler import TesseraeScheduler
from repro_torch.core.simulator import SimConfig, Simulator
from repro_torch.core.traces import TABLE1_MODELS
from repro_torch.workloads import failures as port_failures
from tests.test_torch_round import _one_torch_thread  # noqa: F401  (autouse)

ROUND = 360.0


@pytest.fixture(scope="module")
def profile():
    return ThroughputProfile()


def _scheduler(cluster, profile, **kw):
    kw.setdefault("lap_backend", "numpy")
    kw.setdefault("migration_algorithm", "node")
    return TesseraeScheduler(cluster, TiresiasPolicy(profile), profile, device="cpu", **kw)


def _tiny_trace(profile, num_jobs, seed, max_rounds=6):
    """Jobs sized in ROUNDS (not hours) so chaos sims stay fast."""
    rng = np.random.default_rng([seed, 0xC4A05])
    specs = []
    for i in range(num_jobs):
        model = TABLE1_MODELS[int(rng.integers(len(TABLE1_MODELS)))]
        gpus = int(rng.choice([1, 1, 2, 4]))
        rate = profile.isolated(model, gpus, "dp")
        rounds = 2 + int(rng.integers(max_rounds))
        specs.append(
            JobSpec(
                job_id=i,
                model=model,
                num_gpus=gpus,
                total_iters=rate * ROUND * rounds,
                arrival_time=float(rng.integers(0, 6)) * ROUND,
            )
        )
    return specs


class _RecordingSim(Simulator):
    """Simulator that logs every crash as ``(job_id, retries_after,
    crash_time, eligible_time, terminal)``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.crash_log = []

    def _crash_job(self, st, s, preempt):
        super()._crash_job(st, s, preempt)
        self.crash_log.append(
            (s.job_id, s.retries, st.now, s.eligible_time, s.failed)
        )


def _chaos_recipe(wl, seed):
    """The fault model of ``test_faults.py``'s chaos sequence for one seed,
    built from the failures module ``wl`` (the JAX package's or the
    port's)."""
    return wl.FailureRecipe(
        nodes=wl.NodeOutages(
            mtbf_h=0.3 + 0.2 * (seed % 4),
            repair_median_s=600.0,
            repair_sigma=0.5,
        ),
        gpus=wl.GpuDegradations(rate_per_node_per_day=24.0) if seed % 3 == 0 else None,
    )


def _events(cluster_nodes, trace, seed):
    """The chaos sequence of ``test_faults.py`` for one seed, generated by
    the JAX package, as port events."""
    rng = np.random.default_rng([seed, 0xC4A06])
    events = jax_failures.generate_failures(
        _chaos_recipe(jax_failures, seed), JaxClusterSpec(cluster_nodes, 4), 40 * ROUND, seed,
    )
    # per-job software failures, directly authored
    for s in trace:
        if rng.random() < 0.3:
            events.append(JaxFailureEvent(
                s.arrival_time + float(rng.uniform(0, 8 * ROUND)),
                JOB_FAIL, job_id=s.job_id,
            ))
    events.sort(key=JaxFailureEvent.sort_key)
    return [FailureEvent.from_dict(e.to_dict()) for e in events]


def _port_events(cluster_nodes, trace, seed):
    """The same chaos sequence generated by the port's own workloads
    package, with no JAX object on the way."""
    rng = np.random.default_rng([seed, 0xC4A06])
    events = port_failures.generate_failures(
        _chaos_recipe(port_failures, seed), ClusterSpec(cluster_nodes, 4), 40 * ROUND, seed,
    )
    for s in trace:
        if rng.random() < 0.3:
            events.append(FailureEvent(
                s.arrival_time + float(rng.uniform(0, 8 * ROUND)),
                JOB_FAIL, job_id=s.job_id,
            ))
    events.sort(key=FailureEvent.sort_key)
    return events


@pytest.mark.parametrize("seed", range(12))
def test_port_generator_gives_the_jax_chaos_events(profile, seed):
    num_nodes = 2 + seed % 3
    trace = _tiny_trace(profile, 5 + seed % 4, seed)
    port = _port_events(num_nodes, trace, seed)
    assert port and port == _events(num_nodes, trace, seed)
    assert all(type(e) is FailureEvent for e in port)


def _chaos_bulk(profile, seeds, events_of):
    """Run the chaos sequence of every seed through the port's simulator,
    asserting the per-round safety invariants, and check that the sweep
    exercised the machinery.  ``events_of(num_nodes, trace, seed)`` makes
    the failure events."""
    totals = {"events": 0, "preempt": 0, "retries": 0, "failed": 0,
              "crashes": 0}
    for seed in seeds:
        num_nodes = 2 + seed % 3
        cluster = ClusterSpec(num_nodes, 4)
        trace = _tiny_trace(profile, 5 + seed % 4, seed)
        events = events_of(num_nodes, trace, seed)
        assert events == sorted(events, key=FailureEvent.sort_key)

        cfg = SimConfig(
            max_time_s=200 * ROUND,
            max_retries=3,
            backoff_base_s=ROUND,
            checkpoint_interval_s=2 * ROUND,
        )
        sched = _scheduler(cluster, profile)

        def hook(round_idx, now, decision, states, health,
                 cluster=cluster, cfg=cfg, seed=seed):
            gmap = decision.plan.job_gpu_map()
            per_gpu = {}
            for jid, gpus in gmap.items():
                s = states[jid]
                assert len(gpus) == s.num_gpus, (
                    f"seed {seed}: gang of job {jid} broken"
                )
                # the decision was taken at now - round (the hook fires
                # after the clock advanced); a job inside its backoff
                # window is never placed
                assert s.eligible_time <= now - cfg.round_duration_s + 1e-9, (
                    f"seed {seed} round {round_idx}: job {jid} placed "
                    f"before its backoff expired"
                )
                for g in gpus:
                    node = cluster.node_of(g)
                    assert health.up[node], (
                        f"seed {seed} round {round_idx}: job {jid} "
                        f"placed on down node {node}"
                    )
                    per_gpu[g] = per_gpu.get(g, 0) + 1
            assert all(v <= MAX_PACK for v in per_gpu.values()), (
                f"seed {seed}: GPU capacity exceeded"
            )
            for s in states.values():
                assert s.retries <= cfg.max_retries + 1, (
                    f"seed {seed}: retry budget exceeded on job {s.job_id}"
                )

        sim = _RecordingSim(
            cluster, trace, sched, profile, cfg,
            failures=events, round_hook=hook,
        )
        res = sim.run()

        # realised backoff schedule: every non-terminal crash sets
        # eligibility exactly backoff_base * factor**(retries-1) out
        for jid, retries, t_crash, elig, failed in sim.crash_log:
            if failed:
                continue
            expected = t_crash + cfg.backoff_base_s * (
                cfg.backoff_factor ** (retries - 1)
            )
            assert elig == pytest.approx(expected), (
                f"seed {seed}: job {jid} backoff #{retries} off-schedule"
            )
        totals["crashes"] += len(sim.crash_log)

        # no job lost: everything completed or is a terminal failure
        for jid, s in res.jobs.items():
            assert s.finished, f"seed {seed}: job {jid} never finished"
            if s.failed:
                assert s.retries == cfg.max_retries + 1
                assert jid in res.failed_jobs
            else:
                assert s.iters_done >= s.spec.total_iters - 1e-6, (
                    f"seed {seed}: job {jid} short of its work"
                )
        assert res.lost_iters_total >= 0.0
        assert len(res.degrade_rounds) == res.num_rounds
        totals["events"] += res.fault_events_applied
        totals["preempt"] += res.preemptions
        totals["retries"] += res.retries_total
        totals["failed"] += len(res.failed_jobs)
    # the sweep must actually exercise the machinery, not dodge it
    assert totals["events"] > len(seeds)
    assert totals["preempt"] > 0
    assert totals["failed"] > 0
    assert totals["retries"] >= totals["preempt"]
    assert totals["crashes"] == totals["retries"]


class TestChaosInvariants:
    NUM_SEEDS = 200

    def test_chaos_invariants_bulk(self, profile):
        _chaos_bulk(profile, range(self.NUM_SEEDS), _events)

    @pytest.mark.parametrize("block", range(4))
    def test_chaos_invariants_with_the_ports_generator(self, profile, block):
        """The same 200 seeds in four blocks, their events made by the port's
        own ``generate_failures``."""
        _chaos_bulk(profile, range(50 * block, 50 * block + 50), _port_events)
