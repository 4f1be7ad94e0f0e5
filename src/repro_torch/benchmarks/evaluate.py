"""End-to-end policy-evaluation harness: {policy x scenario x cluster}.

The port's copy of the JAX repo's ``benchmarks/evaluate.py``, run as

    python -m repro_torch.benchmarks.evaluate [--device cpu] [--smoke | --chaos] [--json PATH]

Every arm drives one scheduler configuration (Tesserae-T vs the
Tiresias / Tiresias-Single / Gavel baselines in
``repro_torch.core.policies``) over one named workload scenario from the
:mod:`repro_torch.workloads` registry, through the round-based
:class:`~repro_torch.core.simulator.Simulator` on ``--device`` (the card
unless the caller asks for the CPU), with ONE identity-keyed
:class:`~repro_torch.core.matching.MatchContext` threaded across the arm's
rounds (the production configuration — warm-start telemetry is recorded
per arm).  Its document has ``BENCH_endtoend.json``'s schema, and with the
record's configuration (the defaults) its decisions equal the record's;
it is written only where ``--json`` says:

* per-arm metrics: avg / p50 / p90 / p99 JCT, makespan, migrations,
  rounds, scheduler overhead;
* per-arm warm-hit telemetry: memo / warm / cold instances, warm-hit
  rounds, auction bid iterations;
* per-scenario derived speedups of the Tesserae arm over each baseline
  (the paper's headline avg-JCT / makespan ratios).

``--smoke`` is the CI lane: a tiny sweep (2 policies x 2 scenarios x 16
GPUs) gated on metric-schema validity, bit-identical determinism across
two seeded runs, and warm-hit presence — NEVER on timing.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch import workloads
from repro_torch.benchmarks.common import build_scheduler
from repro_torch.core.profiler import ThroughputProfile
from repro_torch.core.simulator import SimConfig, Simulator
from repro_torch.device import resolve_device

DEFAULT_POLICIES = (
    "tesserae-t",
    "tesserae-t-fa",
    "tiresias",
    "tiresias-single",
    "gavel",
)
DEFAULT_SCENARIOS = (
    "poisson-steady",
    "diurnal-lognorm",
    "philly-like-burst",
    "tiresias-churn",
    "philly-sample",
    "hetero-mixed",
    "node-flaky",
    "philly-failures",
)

#: fields that must be identical across two runs of the same seed (wall
#: times excluded — they are measurements, not decisions)
DETERMINISTIC_METRICS = (
    "avg_jct_s",
    "p50_jct_s",
    "p90_jct_s",
    "p99_jct_s",
    "makespan_s",
    "migrations",
    "rounds",
)
TELEMETRY_KEYS = (
    "warm_instances",
    "memo_instances",
    "cold_instances",
    "bid_iters",
    "warm_hit_rounds",
    "lru_restored_cols",
)
#: per-arm fault/degradation counters (all zero on fault-free scenarios)
FAULT_KEYS = (
    "fault_events_applied",
    "preemptions",
    "retries_total",
    "lost_iters_total",
    "lost_work_s_total",
    "drain_migrations",
    "failed_jobs",
    "fused_host_fallbacks",
)


def run_arm(
    policy: str,
    scenario_name: str,
    num_gpus: int,
    num_jobs: int,
    seed: int,
    backend: str = "auto",
    profile: Optional[ThroughputProfile] = None,
    type_affinity: bool = True,
    obs=None,
    device=None,
) -> Dict:
    profile = profile or ThroughputProfile()
    sc = workloads.scenario(scenario_name)
    cluster = sc.make_cluster(num_gpus)
    rows = sc.make_trace(seed=seed, num_jobs=num_jobs, profile=profile)
    trace = workloads.to_jobspecs(rows, profile)
    # failure horizon: the arrival window plus generous drain slack, so
    # outage processes cover the whole (contended) run
    horizon_s = max((r.arrival_s for r in rows), default=0.0) + 12 * 3600.0
    failures = sc.make_failures(seed, cluster, horizon_s, trace=rows)
    sched = build_scheduler(policy, cluster, profile, resolve_device(device))
    sched.lap_backend = backend
    sched.type_affinity = type_affinity
    # failure-aware arms also adapt the checkpoint cadence against the
    # observed MTBF (inert on fault-free scenarios — no outage, no change)
    cfg = SimConfig(adaptive_checkpoint=policy.endswith("-fa"))
    t0 = time.perf_counter()
    res = Simulator(
        cluster, trace, sched, profile, cfg, failures=failures, obs=obs
    ).run()
    wall = time.perf_counter() - t0

    jcts = res.jcts
    telemetry = {k: 0 for k in TELEMETRY_KEYS}
    for rs in res.match_rounds:
        for k in ("warm_instances", "memo_instances", "cold_instances", "bid_iters"):
            telemetry[k] += int(rs.get(k, 0))
    telemetry["warm_hit_rounds"] = int(res.warm_hit_rounds(skip=1))
    telemetry["lru_restored_cols"] = int(
        sched.match_context.stats.get("lru_restored_cols", 0)
    )
    faults = {
        "fault_events_applied": int(res.fault_events_applied),
        "preemptions": int(res.preemptions),
        "retries_total": int(res.retries_total),
        "lost_iters_total": float(res.lost_iters_total),
        "lost_work_s_total": float(res.lost_work_s_total),
        "drain_migrations": int(res.drain_migrations),
        "failed_jobs": sorted(res.failed_jobs),
        "fused_host_fallbacks": int(res.fused_host_fallbacks),
        "degrade_counts": {
            k: int(v) for k, v in sorted(res.degrade_counts.items())
        },
    }
    return {
        "policy": policy,
        "scenario": scenario_name,
        "num_gpus": num_gpus,
        "num_jobs": len(trace),
        "seed": seed,
        "backend": backend,
        "heterogeneous": bool(cluster.is_heterogeneous),
        "metrics": {
            # SimResult.summary() is the single source of truth for the
            # shared metrics; the harness only adds the p99 tail and
            # integer-types the counters for the JSON record.
            **res.summary(),
            "p99_jct_s": float(np.percentile(jcts, 99)),
            "migrations": int(res.total_migrations),
            "rounds": int(res.num_rounds),
        },
        "match_telemetry": telemetry,
        "faults": faults,
        "wall_s": wall,
    }


def derive_speedups(arms: List[Dict], tesserae: str) -> Dict[str, Dict]:
    """Per-scenario avg-JCT / makespan ratios of every baseline over the
    Tesserae arm (ratio > 1: Tesserae wins)."""
    out: Dict[str, Dict] = {}
    by_scenario: Dict[str, Dict[str, Dict]] = {}
    for a in arms:
        by_scenario.setdefault(a["scenario"], {})[a["policy"]] = a
    for sc_name, by_pol in sorted(by_scenario.items()):
        tess = by_pol.get(tesserae)
        if tess is None:
            continue
        entry = {}
        for pol, arm in sorted(by_pol.items()):
            if pol == tesserae:
                continue
            entry[pol] = {
                "jct_x": arm["metrics"]["avg_jct_s"] / tess["metrics"]["avg_jct_s"],
                "makespan_x": arm["metrics"]["makespan_s"]
                / tess["metrics"]["makespan_s"],
            }
        out[sc_name] = entry
    return out


def validate_schema(doc: Dict) -> List[str]:
    """Structural gate for the smoke lane: every arm carries finite
    metrics and the full telemetry key set."""
    problems = []
    for a in doc["arms"]:
        tag = f"{a.get('policy')}/{a.get('scenario')}"
        for k in DETERMINISTIC_METRICS + ("overhead_total_s",):
            v = a.get("metrics", {}).get(k)
            if v is None or not math.isfinite(float(v)):
                problems.append(f"{tag}: metric {k} missing/non-finite: {v!r}")
        for k in TELEMETRY_KEYS:
            if k not in a.get("match_telemetry", {}):
                problems.append(f"{tag}: telemetry key {k} missing")
        for k in FAULT_KEYS:
            if k not in a.get("faults", {}):
                problems.append(f"{tag}: fault-telemetry key {k} missing")
        if a.get("metrics", {}).get("rounds", 0) <= 0:
            problems.append(f"{tag}: simulation ran 0 rounds")
    return problems


def _deterministic_view(arms: List[Dict]) -> List[Dict]:
    return [
        {
            "policy": a["policy"],
            "scenario": a["scenario"],
            "metrics": {k: a["metrics"][k] for k in DETERMINISTIC_METRICS},
            "telemetry": dict(a["match_telemetry"]),
            "faults": {k: a["faults"][k] for k in FAULT_KEYS},
        }
        for a in arms
    ]


def run_sweep(
    policies, scenarios, num_gpus, num_jobs, seed, backend, verbose=True, device=None
) -> Dict:
    profile = ThroughputProfile()
    arms = []
    for sc_name in scenarios:
        for pol in policies:
            arm = run_arm(
                pol, sc_name, num_gpus, num_jobs, seed, backend, profile, device=device
            )
            arms.append(arm)
            if verbose:
                m = arm["metrics"]
                t = arm["match_telemetry"]
                print(
                    f"{sc_name:>18s} x {pol:<16s} avg_jct={m['avg_jct_s']:8.0f}s "
                    f"p99={m['p99_jct_s']:8.0f}s makespan={m['makespan_s']:8.0f}s "
                    f"mig={m['migrations']:4d} warm={t['warm_instances']:6d} "
                    f"({arm['wall_s']:.1f}s)"
                )
    tesserae = next((p for p in policies if p.startswith("tesserae")), policies[0])
    return {
        "benchmark": "endtoend_policy_eval",
        "config": {
            "policies": list(policies),
            "scenarios": list(scenarios),
            "num_gpus": num_gpus,
            "num_jobs": num_jobs,
            "seed": seed,
            "backend": backend,
        },
        "arms": arms,
        "speedups_vs_" + tesserae: derive_speedups(arms, tesserae),
    }


def smoke(args) -> int:
    """CI gate: tiny sweep, structural + determinism + warm-hit checks."""
    policies = ("tesserae-t", "tiresias")
    scenarios = ("poisson-steady", "tiresias-churn")
    kw = dict(
        policies=policies,
        scenarios=scenarios,
        num_gpus=16,
        num_jobs=args.jobs or 24,
        seed=args.seed,
        backend=args.backend,
        device=args.device,
    )
    doc1 = run_sweep(**kw)
    doc2 = run_sweep(**kw, verbose=False)
    failures = validate_schema(doc1)
    if _deterministic_view(doc1["arms"]) != _deterministic_view(doc2["arms"]):
        failures.append("two seeded runs disagree: sweep is not deterministic")
    warm = [
        a
        for a in doc1["arms"]
        if a["policy"] == "tesserae-t" and a["match_telemetry"]["warm_instances"] > 0
    ]
    if not warm:
        failures.append("no tesserae arm served warm instances from its MatchContext")
    # hetero type-affinity gate (placement type-blindness bugfix): on the
    # heterogeneous scenario, the affinity placement key must not regress
    # average JCT vs the type-blind best-fit it replaces.
    kw_h = dict(
        num_gpus=16,
        num_jobs=args.jobs or 24,
        seed=args.seed,
        backend=args.backend,
        device=args.device,
    )
    aff_on = run_arm("tesserae-t", "hetero-mixed", type_affinity=True, **kw_h)
    aff_off = run_arm("tesserae-t", "hetero-mixed", type_affinity=False, **kw_h)
    jct_on = aff_on["metrics"]["avg_jct_s"]
    jct_off = aff_off["metrics"]["avg_jct_s"]
    if jct_on > jct_off:
        failures.append(
            f"hetero-mixed avg JCT regressed with type affinity on: "
            f"{jct_on:.1f}s (on) > {jct_off:.1f}s (off)"
        )
    doc1["hetero_affinity_gate"] = {
        "avg_jct_s_affinity_on": jct_on,
        "avg_jct_s_affinity_off": jct_off,
    }
    # observability gate: tracing must be decision-inert — an obs-enabled
    # rerun of one tesserae arm must match the plain arm's deterministic
    # view exactly, and the exported trace must be schema-valid.
    from repro_torch.obs import Observability, to_chrome_trace, validate_chrome_trace

    obs = Observability()
    obs_arm = run_arm(
        "tesserae-t",
        scenarios[0],
        num_gpus=16,
        num_jobs=args.jobs or 24,
        seed=args.seed,
        backend=args.backend,
        obs=obs,
        device=args.device,
    )
    plain_arm = next(
        a
        for a in doc1["arms"]
        if a["policy"] == "tesserae-t" and a["scenario"] == scenarios[0]
    )
    if _deterministic_view([obs_arm]) != _deterministic_view([plain_arm]):
        failures.append(
            "obs-enabled arm diverged from the plain arm: tracing perturbed decisions"
        )
    trace_doc = to_chrome_trace(obs.tracer)
    for p in validate_chrome_trace(trace_doc):
        failures.append(f"obs trace invalid: {p}")
    if not trace_doc["traceEvents"]:
        failures.append("obs-enabled arm produced an empty trace")
    if args.obs_trace:
        with open(args.obs_trace, "w") as f:
            json.dump(trace_doc, f)
        print("wrote obs trace:", args.obs_trace)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc1, f, indent=1, sort_keys=True)
    for p in failures:
        print("SMOKE FAIL:", p, file=sys.stderr)
    print("eval-smoke:", "FAIL" if failures else "PASS")
    return 1 if failures else 0


def chaos_smoke(args) -> int:
    """CI chaos gate: one failure scenario end-to-end, gated on safety
    invariants and seeded determinism — NEVER on timing."""
    kw = dict(
        policies=("tesserae-t", "tesserae-t-fa", "tiresias"),
        scenarios=("node-flaky", "philly-failures"),
        num_gpus=16,
        num_jobs=args.jobs or 24,
        seed=args.seed,
        backend=args.backend,
        device=args.device,
    )
    doc1 = run_sweep(**kw)
    doc2 = run_sweep(**kw, verbose=False)
    failures = validate_schema(doc1)
    if _deterministic_view(doc1["arms"]) != _deterministic_view(doc2["arms"]):
        failures.append("two seeded chaos runs disagree: faults are not deterministic")
    for a in doc1["arms"]:
        tag = f"{a['policy']}/{a['scenario']}"
        if a["faults"]["fault_events_applied"] == 0:
            failures.append(f"{tag}: failure scenario applied zero fault events")
        # safety: nothing silently lost — the simulator accounts every job
        # as finished or terminally failed (rounds bounded => no livelock)
        done = a["num_jobs"]
        if a["metrics"]["rounds"] <= 0 or not math.isfinite(
            a["metrics"]["makespan_s"]
        ):
            failures.append(f"{tag}: chaos run did not complete ({done} jobs)")
    flaky = [a for a in doc1["arms"] if a["scenario"] == "node-flaky"]
    if flaky and all(a["faults"]["preemptions"] == 0 for a in flaky):
        failures.append("node-flaky: no arm recorded a node-down preemption")
    # failure-aware arm activity gate: under the degradation-bearing mix
    # (philly-failures carries GPU degradations; node-flaky is
    # outages-only) the tesserae-t-fa arm must actually exercise the
    # straggler-drain relabel path — an invariant, never a timing gate.
    fa_philly = [
        a
        for a in doc1["arms"]
        if a["policy"] == "tesserae-t-fa" and a["scenario"] == "philly-failures"
    ]
    if fa_philly and all(
        a["faults"]["drain_migrations"] == 0 for a in fa_philly
    ):
        failures.append(
            "philly-failures: tesserae-t-fa recorded zero drain migrations "
            "(straggler-drain relabel path never activated)"
        )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc1, f, indent=1, sort_keys=True)
    for p in failures:
        print("CHAOS FAIL:", p, file=sys.stderr)
    print("chaos-smoke:", "FAIL" if failures else "PASS")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--policies", default=",".join(DEFAULT_POLICIES))
    ap.add_argument("--scenarios", default=",".join(DEFAULT_SCENARIOS))
    ap.add_argument("--gpus", type=int, default=48)
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto")
    ap.add_argument(
        "--device",
        default=None,
        help="where the schedulers run: the card (default) or 'cpu'",
    )
    ap.add_argument("--json", default=None, help="write the result document here")
    ap.add_argument(
        "--obs-trace",
        default=None,
        help="(--smoke) write the obs-enabled arm's Chrome/Perfetto trace here",
    )
    ap.add_argument("--smoke", action="store_true", help="CI smoke lane")
    ap.add_argument(
        "--chaos", action="store_true", help="CI chaos-smoke lane (failure scenarios)"
    )
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args)
    if args.chaos:
        return chaos_smoke(args)
    doc = run_sweep(
        policies=tuple(args.policies.split(",")),
        scenarios=tuple(args.scenarios.split(",")),
        num_gpus=args.gpus,
        num_jobs=args.jobs or 100,
        seed=args.seed,
        backend=args.backend,
        device=args.device,
    )
    problems = validate_schema(doc)
    for p in problems:
        print("SCHEMA:", p, file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print("wrote", args.json)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
