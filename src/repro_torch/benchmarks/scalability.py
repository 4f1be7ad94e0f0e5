"""Fig. 2 / Fig. 14(a): decision-making time vs number of active jobs,
plus the matching-engine cluster-scale sweep (the port's copy of the JAX
repo's ``benchmarks/scalability.py``), run as

    python -m repro_torch.benchmarks.scalability [--device cpu] [--skip-cluster-sweep] [--json PATH]

Part 1 (paper figure): 256-GPU cluster (64 nodes x 4), one full scheduling
round per measurement.  Validates the headline scalability claim: Tesserae
decides in < 1.6 s with 2048 active jobs (and < 1 s at 3000 in the paper's
§4.2 discussion), while Gavel's LP grows superlinearly in its O(n^2)
packing variables and POP only partially recovers.

Part 2 (beyond paper): one full Tesserae round at growing cluster scale —
256, 1024 and 2048 GPUs — with the migration/packing LAPs dispatched
through each matching-engine backend (``scipy`` vs ``auction`` vs
``auction_kernel``).  On the card ``auction_kernel`` runs the
``lap_auction`` kernel; on the CPU it runs its plain loop (the JAX script
skips it off the TPU, where its Pallas kernel would run interpreted).

The schedulers run on ``--device`` (the card unless the caller asks for
the CPU); the LP baselines are host code.  The JSON perf record is written
only where ``--json`` says.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Sequence

from repro_torch.benchmarks.common import csv_row
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.policies import GavelPolicy, PopPolicy, TiresiasPolicy
from repro_torch.core.profiler import ThroughputProfile
from repro_torch.core.scheduler import TesseraeScheduler
from repro_torch.core.traces import synthetic_active_jobs
from repro_torch.device import resolve_device

CLUSTER = ClusterSpec(64, 4)  # 256 GPUs
JOB_COUNTS = [128, 512, 1024, 2048]
LP_JOB_CAP = 1024  # LP baselines above this take minutes (that's the point)
PAPER_CLAIM_S = 1.6  # decision time at 2048 active jobs on 256 GPUs

#: Part-2 sweep: (nodes, gpus_per_node) up to a 2048-GPU cluster (512 nodes
#: -> the Algorithm-2 fan-out batches 512 node-pair LAPs per logical node).
SCALE_CLUSTERS = [(64, 4), (256, 4), (512, 4)]
SCALE_BACKENDS = ["scipy", "auction", "auction_kernel"]
SCALE_JOBS = 512


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def tesserae_round_time(
    num_jobs: int, profile, cluster=CLUSTER, backend="auto", device=None
) -> dict:
    """One cold full round (the PR-1 comparable ``total_s``) plus one WARM
    round: the scheduler's persistent ``MatchContext`` carries the packing
    / migration price state from the previous round, so ``warm_total_s``
    is the steady-state per-round decision time (placements change little
    round-to-round; identical fan-outs memo-hit outright).  Each time ends
    with the device's queue drained."""
    device = resolve_device(device)
    jobs = synthetic_active_jobs(num_jobs, seed=1, profile=profile)
    sched = TesseraeScheduler(
        cluster, TiresiasPolicy(profile), profile, lap_backend=backend, device=device
    )
    d1 = sched.decide(jobs, now=0.0)
    sched.match_context.reset()  # keep total_s comparable to the PR-1 record
    _sync(device)
    t0 = time.perf_counter()
    d2 = sched.decide(jobs, now=360.0, prev_plan=d1.plan)
    _sync(device)
    total = time.perf_counter() - t0
    t0 = time.perf_counter()
    d3 = sched.decide(jobs, now=720.0, prev_plan=d2.plan)
    _sync(device)
    warm_total = time.perf_counter() - t0
    return {
        "total_s": total,
        "warm_total_s": warm_total,
        "warm_migrate_s": d3.timings["migrate_s"],
        # identity-keyed context telemetry of the warm round: memo/warm
        # instance counts + bid iterations (regression signal for the
        # steady-state fast path, independent of wall clock)
        "warm_match_stats": dict(d3.match_stats),
        **d2.timings,
    }


def lp_round_time(num_jobs: int, profile, pop: bool) -> float:
    jobs = synthetic_active_jobs(num_jobs, seed=1, profile=profile)
    pol = PopPolicy(profile) if pop else GavelPolicy(profile)
    t0 = time.perf_counter()
    pol.refresh(jobs, CLUSTER)
    solve = time.perf_counter() - t0
    return solve


def bench_paper_figure(
    profile,
    rows: List[str],
    records: List[Dict],
    backend: str = "auto",
    device=None,
    lp: bool = True,
    job_counts: Sequence[int] = JOB_COUNTS,
) -> None:
    """Part 1 under one matching backend; ``lp`` adds the Gavel / POP LP
    rows (host code, up to ``LP_JOB_CAP`` jobs)."""
    claim = None
    for n in job_counts:
        t = tesserae_round_time(n, profile, backend=backend, device=device)
        rows.append(
            csv_row(
                f"scalability/tesserae_jobs{n}_{backend}",
                t["total_s"] * 1e6,
                f"decision_s={t['total_s']:.3f};warm_s={t['warm_total_s']:.3f};"
                f"pack_s={t['pack_s']:.3f};migrate_s={t['migrate_s']:.3f}",
            )
        )
        records.append(
            {
                "bench": "decision_time",
                "backend": backend,
                "jobs": n,
                "gpus": CLUSTER.num_gpus,
                **t,
            }
        )
        if n == 2048:
            claim = t["total_s"]
        if lp and n <= LP_JOB_CAP:
            g = lp_round_time(n, profile, pop=False)
            p = lp_round_time(n, profile, pop=True)
            rows.append(csv_row(f"scalability/gavel_jobs{n}", g * 1e6, f"lp_solve_s={g:.3f}"))
            rows.append(csv_row(f"scalability/pop_jobs{n}", p * 1e6, f"lp_solve_s={p:.3f}"))
            records.append({"bench": "lp_baseline", "policy": "gavel", "jobs": n, "time_s": g})
            records.append({"bench": "lp_baseline", "policy": "pop", "jobs": n, "time_s": p})
    if claim is None:
        return
    rows.append(
        csv_row(
            f"scalability/claim_2048jobs_under_1.6s_{backend}",
            claim * 1e6,
            f"paper_claim={PAPER_CLAIM_S}s;ours={claim:.3f}s;pass={claim < PAPER_CLAIM_S}",
        )
    )
    records.append(
        {
            "bench": "claim",
            "backend": backend,
            "jobs": 2048,
            "time_s": claim,
            "pass": claim < PAPER_CLAIM_S,
        }
    )


def bench_cluster_scale(
    profile,
    rows: List[str],
    records: List[Dict],
    backends: Sequence[str] = SCALE_BACKENDS,
    device=None,
    clusters=SCALE_CLUSTERS,
) -> None:
    """One full round per (cluster size x engine backend)."""
    for nodes, gpn in clusters:
        cluster = ClusterSpec(nodes, gpn)
        for backend in backends:
            t = tesserae_round_time(SCALE_JOBS, profile, cluster, backend, device)
            rows.append(
                csv_row(
                    f"scalability/cluster{cluster.num_gpus}gpu_{backend}",
                    t["total_s"] * 1e6,
                    f"gpus={cluster.num_gpus};jobs={SCALE_JOBS};"
                    f"migrate_s={t['migrate_s']:.3f};pack_s={t['pack_s']:.3f}",
                )
            )
            records.append(
                {
                    "bench": "cluster_scale",
                    "backend": backend,
                    "nodes": nodes,
                    "gpus": cluster.num_gpus,
                    "jobs": SCALE_JOBS,
                    **t,
                }
            )


def main(argv=None) -> List[str]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", default=None, help="write the JSON perf record here")
    parser.add_argument(
        "--device", default=None, help="where the schedulers run: the card (default) or 'cpu'"
    )
    parser.add_argument(
        "--skip-cluster-sweep",
        action="store_true",
        help="only run the paper-figure measurements (Part 1)",
    )
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    profile = ThroughputProfile()
    rows: List[str] = []
    records: List[Dict] = []
    bench_paper_figure(profile, rows, records, device=device)
    if not args.skip_cluster_sweep:
        bench_cluster_scale(profile, rows, records, device=device)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(
                {"benchmark": "scalability", "device": str(device), "records": records},
                f,
                indent=2,
            )
        rows.append(csv_row("scalability/json_report", 0.0, f"path={args.json}"))

    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
