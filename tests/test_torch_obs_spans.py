"""The port's stage spans: inside ``lap.solve``, ``pack`` and
``migrate.host``, and the simulator's own, on the CPU.

Three ``decide`` rounds with an ``Observability`` bundle (the cold round,
one with ``prev_plan``, one after churn) through each LAP backend family:
the stages appear in order and cover their parent, ``syncs`` adds up to the
engine's ``host_syncs`` plus K5's read-back, tracing changes no decision,
and the untraced path makes no CUDA event.  A packing replay whose warm
rounds adopt the exact answer: ``lap.fallback`` counts the answers the host
worker solved ahead.  On a typed or racked cluster, ``migrate.penalties``
and ``pack.types`` wrap the typed terms; a homogeneous round opens neither.
On a card, the spans that launch work carry its device time, and untraced
rounds make no CUDA event.  This file imports neither JAX nor the JAX
package, so its card cases run on the card's host too.
"""

import functools

import numpy as np
import pytest
import torch

import repro_torch.core.cluster as tcl
import repro_torch.core.faults as tfa
import repro_torch.core.policies as tpol
import repro_torch.core.profiler as tprof
import repro_torch.core.scheduler as tsch
import repro_torch.core.simulator as tsim
import repro_torch.core.traces as ttr
from repro_torch.core.matching import engine
from repro_torch.device import device_timer
from repro_torch.obs import NULL_TRACER, Observability, to_chrome_trace, validate_chrome_trace
from torch_rect_replay import packing_replay, traced_packing

BACKENDS = ("auction", "auction_kernel", "scipy")
LAP_STAGES = ("lap.prepare", "lap.identity", "lap.run", "lap.check", "lap.fallback", "lap.store")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other CPU ``test_torch_*`` files:
    the tensors are tiny and xdist's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_decisions_equal(da, db):
    np.testing.assert_array_equal(da.plan.slots, db.plan.slots)
    assert [j.job_id for j in da.placed] == [j.job_id for j in db.placed]
    assert [j.job_id for j in da.pending] == [j.job_id for j in db.pending]
    assert da.packing.matches == db.packing.matches
    assert da.packing.total_weight == db.packing.total_weight
    assert (da.migration is None) == (db.migration is None)
    if da.migration is not None:
        assert da.migration.num_migrations == db.migration.num_migrations
        assert da.migration.matching_cost == db.migration.matching_cost
        np.testing.assert_array_equal(da.migration.node_assignment, db.migration.node_assignment)
    assert da.match_stats == db.match_stats


def _three_rounds(backend, obs, device="cpu", cluster=None, **kw):
    cluster = cluster or tcl.ClusterSpec(3, 4)
    prof = tprof.ThroughputProfile()
    sched = tsch.TesseraeScheduler(
        cluster, tpol.TiresiasPolicy(prof), prof, lap_backend=backend, obs=obs, device=device,
        **kw,
    )
    jobs = ttr.synthetic_active_jobs(12, seed=1, profile=prof)
    d1 = sched.decide(jobs, now=0.0)
    d2 = sched.decide(jobs, now=360.0, prev_plan=d1.plan)
    churned = [j for j in jobs if j.job_id % 5 != 2]  # a few jobs finish
    d3 = sched.decide(churned, now=720.0, prev_plan=d2.plan)
    return [d1, d2, d3]


@functools.lru_cache(maxsize=None)
def _traced(backend):
    obs = Observability()
    return _three_rounds(backend, obs), obs.tracer


def _walk(spans):
    for s in spans:
        yield s
        yield from _walk(s.children)


def _decides(tracer):
    return [s for s in _walk(tracer.roots()) if s.name == "decide"]


def _child(span, name):
    (c,) = [c for c in span.children if c.name == name]
    return c


@pytest.mark.parametrize("backend", BACKENDS)
def test_lap_solve_stages_in_order(backend):
    _, tracer = _traced(backend)
    solves = [s for s in _walk(tracer.roots()) if s.name == "lap.solve"]
    assert len(solves) >= 5
    approx = backend != "scipy"
    for s in solves:
        names = [c.name for c in s.children]
        # each stage at most once, in the engine's order, always closed
        assert names == [n for n in LAP_STAGES if n in names]
        assert names[:2] == ["lap.prepare", "lap.identity"] and "lap.check" in names
        assert all(c.dur_s > 0 for c in s.children)
        assert sum(c.dur_s for c in s.children) <= s.dur_s
        # the stages carry only what ``lap.solve`` does not: readouts,
        # memo/warm and instance counts
        assert not _child(s, "lap.prepare").attrs
        assert set(_child(s, "lap.check").attrs) == {"syncs"}
        batch = s.attrs["batch"]
        ident = _child(s, "lap.identity").attrs
        assert 0 <= ident["warm"] <= batch
        if "lap.run" in names:
            run = _child(s, "lap.run").attrs
            assert set(run) == {"instances", "syncs"}
            assert run["instances"] == batch - ident["memo"] >= 1
            assert run["syncs"] == (1 if approx else 0)
        else:
            assert ident["memo"] == batch
        # every solve writes its context back, but the full-memo fast path
        # (the same identities in the same places), whose entry stays right
        assert "lap.store" in names or names == ["lap.prepare", "lap.identity", "lap.check"]
        # the exact re-solve opens its span only where one runs
        if "lap.fallback" in names:
            fb = _child(s, "lap.fallback").attrs
            assert approx and "lap.run" in names
            assert set(fb) == {"instances", "adopted", "ahead", "wait_ms"}
            assert 0 <= fb["adopted"] <= fb["instances"] <= batch
            assert fb["adopted"] <= s.attrs["fallbacks"]
            # the answers the host worker solved ahead, and the join's block
            assert 0 <= fb["ahead"] <= fb["instances"] and fb["wait_ms"] >= 0.0
            if not fb["ahead"]:
                assert fb["wait_ms"] == 0.0
    if backend == "auction":
        # the churned round's packing trips the certificate and re-solves
        assert any("lap.fallback" in [c.name for c in s.children] for s in solves)


def test_packing_fallback_carries_the_answers_solved_ahead():
    """Once a round has adopted the exact answer, the next round's
    ``lap.fallback`` takes it from the host worker: ``ahead`` is its one
    instance, and ``wait_ms`` how long the join blocked."""
    before = dict(vars(engine.exact_ahead))
    results, fbs = traced_packing(packing_replay(1, 4, 5, 14), "auction", "cpu")
    tally = {k: v - before[k] for k, v in vars(engine.exact_ahead).items()}
    assert fbs[0] is None and [r.used_fallback[0] for r in results] == [False] + [True] * 3
    assert [fb["ahead"] for fb in fbs[1:]] == [0, 1, 1]
    assert all(fb["instances"] == 1 and fb["wait_ms"] >= 0.0 for fb in fbs[1:])
    assert tally == dict(started=2, used=2, dropped=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pack_and_migrate_hold_their_stages(backend):
    decisions, tracer = _traced(backend)
    decides = _decides(tracer)
    assert len(decides) == 3
    for k, (d, dec) in enumerate(zip(decides, decisions)):
        pack = _child(d, "pack")
        names = [c.name for c in pack.children]
        assert names[:3] == ["pack.graph", "lap.solve", "pack.apply"]
        # the walk over the matches, then apply_packing where there are any
        assert names[3:] == (["pack.apply"] if dec.packing.matches else [])
        assert pack.children[1].attrs["family"] == "packing"
        assert not any(c.attrs for c in pack.children[:1] + pack.children[2:])
        if k == 0:
            assert "migrate.host" not in [c.name for c in d.children]  # no prev_plan
            continue
        mig = _child(d, "migrate.host")
        assert [c.name for c in mig.children] == [
            "migrate.prepare", "migrate.cost", "lap.solve", "lap.solve", "migrate.assemble",
        ]
        assert [c.attrs["family"] for c in mig.children[2:4]] == [
            "migration_pairs", "migration_node",
        ]
        assert mig.children[1].attrs == {"syncs": 1}  # K5's read-back
        assert not mig.children[0].attrs and not mig.children[4].attrs
        for parent in (pack, mig):
            assert sum(c.dur_s for c in parent.children) <= parent.dur_s


TYPED_CLUSTERS = {
    # (types, nodes_per_rack) -> the attributes of ``migrate.penalties``
    "homogeneous": ((None, 0), None),
    "typed-racked": ((("a100", "a100", "v100", "v100"), 2), {"types": 2, "racks": 2}),
    "typed": ((("a100", "v100", "a100", "v100"), 0), {"types": 2, "racks": 1}),
    "racked": ((None, 1), {"types": 1, "racks": 4}),
}


@pytest.mark.parametrize("algorithm", ["node", "flat"])
@pytest.mark.parametrize("kind", sorted(TYPED_CLUSTERS))
def test_typed_terms_open_their_spans(kind, algorithm):
    """On a typed or racked cluster, ``migrate.penalties`` wraps the relabel
    penalties (the node match's or the flat LAP's) and ``pack.types`` the
    placed jobs' node types, each with exactly its attributes; a cluster
    of one type opens no ``pack.types``, and a homogeneous one neither."""
    (types, per_rack), pen_attrs = TYPED_CLUSTERS[kind]
    obs = Observability()
    cluster = tcl.ClusterSpec(4, 4, node_gpu_types=types, nodes_per_rack=per_rack)
    decisions = _three_rounds("auction", obs, cluster=cluster, migration_algorithm=algorithm)
    decides = _decides(obs.tracer)
    assert len(decides) == 3
    for k, (d, dec) in enumerate(zip(decides, decisions)):
        pack = _child(d, "pack")
        names = [c.name for c in pack.children]
        if types is None:
            assert "pack.types" not in names
        else:
            assert names[:2] == ["pack.types", "pack.graph"]
            assert pack.children[0].attrs == {"rows": len(dec.placed)} and dec.placed
        if k == 0 or pen_attrs is None:
            assert "migrate.penalties" not in [s.name for s in _walk([d])]
            continue
        mig = _child(d, "migrate.host")
        want = ["migrate.prepare", "migrate.cost", "lap.solve", "migrate.penalties", "lap.solve",
                "migrate.assemble"]
        if algorithm == "flat":
            want = ["migrate.prepare", "migrate.cost", "migrate.penalties", "lap.solve",
                    "migrate.assemble"]
        assert [c.name for c in mig.children] == want
        pen = _child(mig, "migrate.penalties")
        assert pen.attrs == pen_attrs and not pen.children and pen.dur_s > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_syncs_add_up_to_the_rounds_host_syncs(backend):
    decisions, tracer = _traced(backend)
    for d, dec in zip(_decides(tracer), decisions):
        spans = list(_walk([d]))
        syncs = sum(s.attrs.get("syncs", 0) for s in spans)
        k5 = sum(1 for s in spans if s.name == "migrate.cost")
        assert syncs == dec.match_stats.get("host_syncs", 0) + k5


@pytest.mark.parametrize("backend", BACKENDS)
def test_tracing_changes_no_decision(backend):
    traced, _ = _traced(backend)
    plain = _three_rounds(backend, None)
    for dt, dp in zip(traced, plain):
        _assert_decisions_equal(dt, dp)


@pytest.mark.parametrize("backend", BACKENDS)
def test_untraced_round_makes_no_cuda_event(backend, monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a device timer was entered with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    # on a CUDA device the timer of a null span creates nothing and hands
    # a C entry no event
    with device_timer(NULL_TRACER.span("x"), torch.device("cuda")) as t:
        assert t.handles() == (None, None)
    plain = _three_rounds(backend, None)
    traced, _ = _traced(backend)
    for dt, dp in zip(traced, plain):
        _assert_decisions_equal(dt, dp)


def test_chrome_export_validates_and_carries_the_epoch():
    _, tracer = _traced("auction")
    doc = to_chrome_trace(tracer)
    assert validate_chrome_trace(doc) == []
    assert doc["otherData"]["epoch_s"] == tracer.epoch_s
    names = {ev["name"] for ev in doc["traceEvents"]}
    assert {"lap.prepare", "lap.run", "pack.graph", "migrate.cost"} <= names
    # no device time on the CPU: the spans keep none and export none
    assert all("device_ms" not in ev.get("args", {}) for ev in doc["traceEvents"])
    assert all(s.to_dict()["device_s"] is None for s in tracer.roots())


def _sim_passes(trace, rounds=None, faults=False, resume_after=None, tmp_path=None):
    """The port's simulator under a tracer on 2 nodes: the roots of each
    pass of its loop, from its scan on (``apply_events`` left out where
    there are faults), the
    indices the round hook saw, and what each round's ``decide`` found in
    the states: the jobs arrived by then and not finished, and the jobs
    holding GPUs.  With ``faults``, every fourth job fails 1.5 and 5.5
    rounds after it arrives (one retry allowed) and node 1 is down for six
    rounds from the arrival of the trace's middle job.  With
    ``resume_after``, the run is saved after that many rounds and finished
    by a new simulator that loads the state."""
    cluster = tcl.ClusterSpec(2, 4)
    prof = tprof.ThroughputProfile()
    sched = tsch.TesseraeScheduler(
        cluster, tpol.TiresiasPolicy(prof), prof, lap_backend="scipy", device="cpu"
    )
    jobs = trace(prof)
    cfg = tsim.SimConfig(max_retries=1)
    events = []
    if faults:
        rnd = cfg.round_duration_s
        for j in jobs[1::4]:
            events += [
                tfa.FailureEvent(j.arrival_time + 1.5 * rnd, tfa.JOB_FAIL, job_id=j.job_id),
                tfa.FailureEvent(j.arrival_time + 5.5 * rnd, tfa.JOB_FAIL, job_id=j.job_id),
            ]
        t = jobs[len(jobs) // 2].arrival_time
        events += [
            tfa.FailureEvent(t, tfa.NODE_DOWN, node=1),
            tfa.FailureEvent(t + 6 * rnd, tfa.NODE_UP, node=1),
        ]
    obs = Observability()
    sims, hooked, seen = [], [], []
    decide = sched.decide

    def watched_decide(active, now, *a, **k):
        states = sims[-1]._state.states
        live = sum(
            1
            for s in states.values()
            if s.spec.arrival_time <= now and (s.finish_time is None or s.finish_time > now)
        )
        holders = sum(1 for s in states.values() if s.gpus and not s.finished)
        seen.append((live, holders))
        return decide(active, now, *a, **k)

    sched.decide = watched_decide

    def simulator():
        sims.append(
            tsim.Simulator(
                cluster, jobs, sched, prof, cfg, failures=events, obs=obs,
                round_hook=lambda *a: hooked.append(a[0]),
            )
        )
        return sims[-1]

    if resume_after is None:
        simulator().run(stop_after_rounds=rounds)
    else:
        path = str(tmp_path / "sim.npz")
        assert simulator().run(stop_after_rounds=resume_after) is None
        sims[-1].save_state(path)
        simulator().load_state(path)
        sims[-1].run(stop_after_rounds=rounds)
    chunks = []
    for r in obs.tracer.roots():
        if faults and r.name == "apply_events":
            continue
        if r.name == "sim.scan":
            chunks.append([])
        chunks[-1].append(r)
    return chunks, hooked, seen


SIM_ROUND = ["sim.scan", "round", "sim.handover", "sim.hook", "sim.contention"]


def _check_live_and_swept(chunks, seen):
    """Each round's ``sim.scan`` carries ``live``, the jobs arrived and not
    finished, and its ``advance_round`` carries ``swept``, the jobs holding
    GPUs when the round began (those the previous round left, less any a
    fault took them from); no other simulator span has an attribute but
    ``round``.  Returns the rounds' ``live``."""
    rounds = [c for c in chunks if [r.name for r in c] == SIM_ROUND]
    assert len(rounds) == len(seen)
    lives = []
    for i, ((scan, rnd, hand, hook, cont), (live, holders)) in enumerate(zip(rounds, seen)):
        # the round's index and active count ride on ``round``
        assert rnd.attrs["index"] == i and rnd.attrs["active"] > 0
        assert scan.attrs == {"live": live} and live >= rnd.attrs["active"]
        assert _child(rnd, "advance_round").attrs == {"swept": holders}
        assert not any(s.attrs for s in (hand, hook, cont))
        lives.append(live)
    return lives


def test_simulator_round_spans():
    """The simulator's own spans, each round: the scan, the round, the
    hand-over, the hook and the contention bookkeeping (``apply_events``
    only in a round with fault events, none here)."""
    chunks, hooked, seen = _sim_passes(
        lambda prof: ttr.shockwave_trace(num_jobs=8, seed=3, profile=prof), rounds=3
    )
    names = [[r.name for r in c] for c in chunks]
    # a pass with no active job (before the first arrival) only scans
    assert all(n in (["sim.scan"], SIM_ROUND) for n in names)
    assert names.count(SIM_ROUND) == 3
    assert len(_check_live_and_swept(chunks, seen)) == 3
    assert hooked == [1, 2, 3]


@pytest.mark.parametrize("faults", [False, True])
def test_simulator_scan_visits_only_live_jobs(faults, tmp_path):
    """On a trace most of whose jobs have finished or not arrived yet, each
    round's scan visits the live jobs alone (``live`` under a quarter of the
    trace), and the release sweep the jobs holding GPUs; through job
    failures, a node outage and a saved and resumed state too."""
    num_jobs = 64
    chunks, hooked, seen = _sim_passes(
        lambda prof: ttr.shockwave_trace(
            num_jobs=num_jobs, arrival_rate_per_hour=4.0, seed=3, profile=prof
        ),
        faults=faults,
        resume_after=100 if faults else None,
        tmp_path=tmp_path,
    )
    lives = _check_live_and_swept(chunks, seen)
    assert len(lives) > 200 and hooked == list(range(1, len(lives) + 1))
    assert max(lives) < num_jobs / 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device timer's events run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("backend", BACKENDS)
def test_untraced_rounds_on_card_make_no_cuda_event(backend, cuda, monkeypatch):
    """With ``obs=None`` on the card, no device timer is built and no
    ``torch.cuda.Event`` is made, whatever the backend launches."""
    import repro_torch.device as tdev

    def no_event(*a, **k):
        raise AssertionError("a device timer was entered with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(tdev, "_DeviceTimer", no_event)
    plain = _three_rounds(backend, None, device=cuda)
    assert len(plain) == 3 and plain[2].migration is not None


def test_spans_that_launch_work_carry_device_time_on_card(cuda):
    obs = Observability()
    _three_rounds("auction_kernel", obs, device=cuda)
    spans = list(_walk(obs.tracer.roots()))
    timed = [s for s in spans if s.name in ("lap.run", "migrate.cost")]
    assert {s.name for s in timed} == {"lap.run", "migrate.cost"}
    for s in timed:
        assert s.device_s is not None and 0 < s.device_s <= s.dur_s, (s.name, s.device_s, s.dur_s)
    assert all(s.device_s is None for s in spans if s.name not in ("lap.run", "migrate.cost"))
    doc = to_chrome_trace(obs.tracer)
    assert any("device_ms" in ev.get("args", {}) for ev in doc["traceEvents"])
