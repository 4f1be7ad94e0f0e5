#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``build/kernels``),
holds each against its plain PyTorch version on the card, then drives the
Tesserae round at 2048 GPUs (512 nodes x 4) through the entry points a
user calls — ``TesseraeScheduler.decide`` and ``Simulator.run`` with
``lap_backend="auction_kernel"`` — and checks what comes out:

1. environment: the card, torch/CUDA versions, the kernels' build time;
2. kernels vs their plain versions at the main path's shapes (exact), with
   kernel / plain / bound / library times;
3. the main path: (a) ``decide()`` x3 on 512 synthetic jobs (cold, with
   the previous plan, warm), as the scalability benchmark does, and (b)
   ``Simulator.run(stop_after_rounds=6)`` on a 2048-job shockwave trace
   whose backlog exceeds the cluster, so the packing LAP runs; the launch
   counters are zeroed just before and read just after, and both kernels
   must have launched;
4. correctness: (a) re-run with the plain top-2 (``lap_backend="auction"``)
   reproduces every plan and matching cost bit for bit; each migrate step
   re-solved with scipy has the same optimal matching cost; every plan is
   feasible.

Any failure exits non-zero.  The last three lines are the kernels JSON,
the card's ``name, power.limit`` and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM peaks (data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
PEAK_F64_OPS_PER_S = 34e12  # f64 outside the tensor cores (data sheet)

FULL = dict(nodes=512, jobs_decide=512, jobs_sim=2048, sim_rounds=6, fanout=262144)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, device, reps=20, warmup=3):
    """Mean milliseconds per call of ``fn`` issued eagerly from the host
    (CUDA events; includes the host's dispatch when it is the slower side)."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type != "cuda":  # CPU rehearsal only; never reported
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, device, reps=20, replays=5):
    """Mean DEVICE milliseconds per call of ``fn``: ``reps`` calls captured
    in one CUDA graph and replayed, so the host's per-call dispatch (the
    wrapper's checks, allocation and ctypes call) is not in the time."""
    import torch

    if device.type != "cuda":  # CPU rehearsal only; never reported
        return timed(fn, device, reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(nbytes, ops, ops_rate):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def bid_case(shape, device, gen, ties=False):
    import torch

    b, n, m = shape
    a = torch.randint(-64, 1, (b, n, m), generator=gen, dtype=torch.int32).float()
    p = torch.randint(0, 8, (b, m), generator=gen, dtype=torch.int32).float()
    if ties:  # duplicated maxima across warp-stride and tile boundaries
        a[:, 0, [31, 32]] = 50.0
        a[:, 1 % n, [5, 37, 69 % m]] = 50.0
        a[:, 2 % n, [511 % m, 512 % m]] = 50.0
        a[:, 3 % n, :] = 1.0
        p[:] = 0.0
    return a.to(device).contiguous(), p.to(device).contiguous()


def compare_lap_bid(shape, device, gen, ties=False, reps=20):
    import torch

    from repro_torch.kernels.lap_bid import lap_bid_batched, lap_bid_top2_plain

    a, p = bid_case(shape, device, gen, ties)
    got = lap_bid_batched(a, p)
    want = lap_bid_top2_plain(a, p)
    if device.type == "cuda":
        torch.cuda.synchronize()
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    for g, w, what in zip(got, want, ("best_v", "best_j", "second")):
        check(torch.equal(g, w), f"lap_bid_batched{shape}{' ties' if ties else ''}: {what} differs from plain")
    b, n, m = shape
    nbytes = 4 * b * n * m + 4 * b * m + 12 * b * n
    bnd, by = bound_ms(nbytes, 3 * b * n * m, PEAK_F32_OPS_PER_S)
    row = dict(
        shape=list(shape),
        max_abs_err=err,
        ms=graph_ms(lambda: lap_bid_batched(a, p), device, reps),
        plain_ms=graph_ms(lambda: lap_bid_top2_plain(a, p), device, reps),
        library_ms=graph_ms(lambda: torch.topk(a - p[:, None, :], 2, dim=-1), device, reps),
        bound_ms=bnd,
        bound_by=by,
        eager_ms=timed(lambda: lap_bid_batched(a, p), device, reps),
    )
    log(f"[kernel] lap_bid_batched {shape}{' ties' if ties else ''}: exact vs plain; "
        + json.dumps(row))
    return row


def compare_migration_cost(u, device, gen, reps=20):
    import torch

    from repro_torch.kernels.migration_cost import migration_cost, migration_cost_plain

    def slots():
        s = torch.randint(0, 512, (u, 2), generator=gen, dtype=torch.int32)
        s[torch.rand((u, 2), generator=gen) < 0.4] = -1
        return s

    su, sv = slots(), slots()
    w_of = 1.0 / (2.0 * torch.tensor([1.0, 2.0, 4.0, 8.0], dtype=torch.float64))
    wu = torch.where(su < 0, 0.0, w_of[su.clamp_min(0) % 4])
    wv = torch.where(sv < 0, 0.0, w_of[sv.clamp_min(0) % 4])
    args = [t.to(device).contiguous() for t in (su, sv, wu, wv)]
    got = migration_cost(*args)
    want = migration_cost_plain(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
          f"migration_cost {u}x{u}: differs from plain (bitwise)")
    nbytes = 8 * u * u + 2 * u * 2 * (4 + 8)
    bnd, by = bound_ms(nbytes, 3 * u * u, PEAK_F64_OPS_PER_S)
    row = dict(
        shape=[u, u, 2],
        max_abs_err=float((got - want).abs().max()),
        ms=graph_ms(lambda: migration_cost(*args), device, reps),
        plain_ms=graph_ms(lambda: migration_cost_plain(*args), device, reps),
        library_ms=None,
        bound_ms=bnd,
        bound_by=by,
        eager_ms=timed(lambda: migration_cost(*args), device, reps),
        readback_ms=timed(lambda: got.cpu(), device, 5, 1),
    )
    log(f"[kernel] migration_cost {u}x{u}: bit-identical to plain; " + json.dumps(row))
    return row


# --------------------------------------------------------------------------- #
# phase 3 / 4: the main path
# --------------------------------------------------------------------------- #
class Recorder:
    """Logs every auction solve (shape, wall time, bid rounds, loop syncs,
    kernel launches; single-column instances) and every Algorithm-3 cost
    build, and keeps the (prev, new_logical) pair of every migrate step,
    by wrapping three module functions of the port for the duration of a
    run.  Each wrapped call already ends in a device->host readout, so its
    host wall time is the device work's too."""

    def __init__(self):
        import repro_torch.core.matching.engine as engine
        import repro_torch.core.migration as migration
        import repro_torch.core.scheduler as scheduler
        from repro_torch.core.matching import auction
        from repro_torch.kernels.lap_bid import lap_bid_batched

        self.mods = (engine, migration, scheduler)
        self.orig = (engine._run_auction, migration._gpu_pair_costs, scheduler.plan_migration)
        self.solves = 0
        self.single_column = 0
        self.migrations = []
        self.events = []

        def run_auction(benefit, *a, **k):
            self.solves += 1
            if benefit.shape[-1] == 1:
                self.single_column += benefit.shape[0]
            s0, l0, t0 = auction.loop_syncs.count, lap_bid_batched.launches, time.perf_counter()
            out = self.orig[0](benefit, *a, **k)
            self.events.append(dict(
                what="auction", shape=list(benefit.shape), wall_s=time.perf_counter() - t0,
                bid_rounds=int(out[3].max()) if len(out[3]) else 0,
                loop_syncs=auction.loop_syncs.count - s0,
                lap_bid_launches=lap_bid_batched.launches - l0,
            ))
            return out

        def gpu_pair_costs(slots_u, slots_v, *a, **k):
            t0 = time.perf_counter()
            out = self.orig[1](slots_u, slots_v, *a, **k)
            self.events.append(dict(what="migration_cost", shape=list(out.shape),
                                    wall_s=time.perf_counter() - t0))
            return out

        def plan_migration(prev, new_logical, gmap, **k):
            res = self.orig[2](prev, new_logical, gmap, **k)
            self.migrations.append((prev, new_logical, dict(gmap), k, res))
            return res

        engine._run_auction = run_auction
        migration._gpu_pair_costs = gpu_pair_costs
        scheduler.plan_migration = plan_migration

    def close(self):
        engine, migration, scheduler = self.mods
        engine._run_auction, migration._gpu_pair_costs, scheduler.plan_migration = self.orig


def check_feasible(plan, gmap, what):
    from repro_torch.core.cluster import EMPTY

    for jid, gpus in plan.job_gpu_map().items():
        check(len(gpus) == gmap[jid], f"{what}: job {jid} holds {len(gpus)} GPUs, wants {gmap[jid]}")
    slots = plan.slots.reshape(-1, plan.slots.shape[-1])
    both = (slots[:, 0] != EMPTY) & (slots[:, 1] != EMPTY)
    check(not (slots[both, 0] == slots[both, 1]).any(), f"{what}: a job packed with itself")


def make_scheduler(cluster, backend, device):
    from repro_torch.core.policies import TiresiasPolicy
    from repro_torch.core.profiler import ThroughputProfile
    from repro_torch.core.scheduler import TesseraeScheduler

    prof = ThroughputProfile()
    sched = TesseraeScheduler(
        cluster, TiresiasPolicy(prof), prof, lap_backend=backend,
        migration_algorithm="node", enable_packing=True, device=device,
    )
    return sched, prof


def decide_three(cluster, backend, device, num_jobs):
    """Three decide() rounds as the scalability benchmark times them."""
    import torch

    from repro_torch.core.matching import auction
    from repro_torch.core.traces import synthetic_active_jobs
    from repro_torch.kernels.lap_bid import lap_bid_batched
    from repro_torch.kernels.migration_cost import migration_cost

    sched, prof = make_scheduler(cluster, backend, device)
    jobs = synthetic_active_jobs(num_jobs, seed=1, profile=prof)
    gmap = {j.job_id: j.num_gpus for j in jobs}
    rec = Recorder()
    rounds = []
    try:
        prev = None
        for i, now in enumerate((0.0, 360.0, 720.0)):
            counts = (lap_bid_batched.launches, migration_cost.launches, auction.loop_syncs.count, rec.solves)
            ev0 = len(rec.events)
            t0 = time.perf_counter()
            d = sched.decide(jobs, now=now, prev_plan=prev)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if i == 0:
                sched.match_context.reset()  # keep round 2 a cold fan-out
            check_feasible(d.plan, gmap, f"{backend} decide {i}")
            row = dict(
                round=i, wall_s=wall, timings=d.timings, match_stats=d.match_stats,
                lap_bid_launches=lap_bid_batched.launches - counts[0],
                migration_cost_launches=migration_cost.launches - counts[1],
                auction_solves=rec.solves - counts[3],
                loop_syncs=auction.loop_syncs.count - counts[2],
                migrations=None if d.migration is None else d.migration.num_migrations,
                matching_cost=None if d.migration is None else d.migration.matching_cost,
                steps=rec.events[ev0:],
            )
            log(f"[decide {backend}] " + json.dumps(row))
            rounds.append((d, row))
            prev = d.plan
    finally:
        rec.close()
    return rounds, rec


def run_sim(cluster, device, num_jobs, stop_after):
    import torch

    from repro_torch.core.simulator import SimConfig, Simulator
    from repro_torch.core.traces import shockwave_trace
    from repro_torch.kernels.lap_bid import lap_bid_batched
    from repro_torch.kernels.migration_cost import migration_cost

    sched, prof = make_scheduler(cluster, "auction_kernel", device)
    trace = shockwave_trace(num_jobs=num_jobs, arrival_rate_per_hour=5000, seed=1, profile=prof)
    gmap = {s.job_id: s.num_gpus for s in trace}
    rows = []
    rec = Recorder()

    def hook(idx, now, decision, states, health):
        check_feasible(decision.plan, gmap, f"sim round {idx}")
        rows.append(dict(
            round=idx, placed=len(decision.placed), pending=len(decision.pending),
            packing_edges=decision.packing.num_edges,
            packed=len(decision.packing.matches), timings=decision.timings,
            match_stats=decision.match_stats, steps=rec.events[hook.seen:],
            launches_so_far={"lap_bid_batched": lap_bid_batched.launches,
                             "migration_cost": migration_cost.launches},
        ))
        hook.seen = len(rec.events)
        log(f"[sim] " + json.dumps(rows[-1]))

    hook.seen = 0
    sim = Simulator(cluster, trace, sched, prof, SimConfig(), round_hook=hook)
    t0 = time.perf_counter()
    try:
        res = sim.run(stop_after_rounds=stop_after)
    finally:
        rec.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"[sim] {len(rows)} rounds in {time.perf_counter() - t0:.3f} s")
    check(res is None and len(rows) == stop_after,
          f"sim ran {len(rows)} rounds, wanted to pause after {stop_after}")
    return rows, rec


def run(device, scale):
    import numpy as np
    import torch

    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.migration import plan_migration
    from repro_torch.kernels import build
    from repro_torch.kernels.lap_bid import lap_bid_batched
    from repro_torch.kernels.migration_cost import migration_cost

    device = torch.device(device)
    gen = torch.Generator().manual_seed(0)

    # ---- phase 1: environment + build -------------------------------------- #
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {device}")
    if device.type == "cuda":
        log(f"[env] {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        build.build_all()
        log(f"[env] kernels built in {build.last_build_s:.3f} s "
            f"(load {time.perf_counter() - t0:.3f} s) into {build.BUILD_DIR}")

    # ---- phase 2: kernels vs plain at the main path's shapes --------------- #
    kn = scale["nodes"]
    lap_rows = {
        "fanout": compare_lap_bid((scale["fanout"], 4, 4), device, gen),
        "node": compare_lap_bid((1, kn, kn), device, gen),
        "ties": compare_lap_bid((4, 8, 600), device, gen, ties=True, reps=5),
    }
    mig_row = compare_migration_cost(kn * 4, device, gen)

    # ---- phase 3: the main path ------------------------------------------- #
    cluster = ClusterSpec(kn, 4)
    lap_bid_batched.launches = 0
    migration_cost.launches = 0
    t0 = time.perf_counter()
    kernel_rounds, kernel_rec = decide_three(cluster, "auction_kernel", device, scale["jobs_decide"])
    sim_rows, sim_rec = run_sim(cluster, device, scale["jobs_sim"], scale["sim_rounds"])
    launches = {"lap_bid_batched": lap_bid_batched.launches, "migration_cost": migration_cost.launches}
    log(f"[main path] {time.perf_counter() - t0:.3f} s; launches {json.dumps(launches)}")
    if device.type == "cuda":  # CPU tensors take the plain versions, uncounted
        check(launches["lap_bid_batched"] > 0, "the main path never launched lap_bid_batched")
        check(launches["migration_cost"] > 0, "the main path never launched migration_cost")

    # the rectangular packing shape a real round solved, kernel vs plain
    packing = [r for r in sim_rows if r["packing_edges"] > 0]
    check(packing, "no simulator round solved a packing LAP")
    big = max(packing, key=lambda r: r["placed"] * r["pending"])
    rect = (1, min(big["placed"], big["pending"]), max(big["placed"], big["pending"]))
    lap_rows["packing"] = compare_lap_bid(rect, device, gen, reps=10)

    # ---- phase 4: correctness on the card ---------------------------------- #
    plain_rounds, plain_rec = decide_three(cluster, "auction", device, scale["jobs_decide"])
    for (dk, rk), (dp, rp) in zip(kernel_rounds, plain_rounds):
        i = rk["round"]
        check(np.array_equal(dk.plan.slots, dp.plan.slots), f"decide {i}: plans differ (kernel vs plain top-2)")
        check(rk["matching_cost"] == rp["matching_cost"], f"decide {i}: matching costs differ")
        check(dk.packing.matches == dp.packing.matches, f"decide {i}: packings differ")
    singles = kernel_rec.single_column + plain_rec.single_column
    log(f"[check] single-column instances: {singles}")
    if singles == 0:
        for (_, rk), (_, rp) in zip(kernel_rounds, plain_rounds):
            check(rk["match_stats"] == rp["match_stats"], f"decide {rk['round']}: match stats differ")
    check(len(kernel_rec.migrations) == 2, "expected two migrate steps in decide x3")
    steps = [("decide", m) for m in kernel_rec.migrations] + [("sim", m) for m in sim_rec.migrations]
    for step, (where, (prev, new_logical, gmap, kw, res)) in enumerate(steps):
        t1 = time.perf_counter()
        ref = plan_migration(prev, new_logical, gmap, algorithm="node", backend="scipy",
                             down_nodes=kw.get("down_nodes"), speed_factor=kw.get("speed_factor"),
                             device=device)
        log(f"[check] {where} migrate step {step}: auction_kernel cost {res.matching_cost} "
            f"scipy cost {ref.matching_cost}; migrations {res.num_migrations} vs "
            f"{ref.num_migrations} ({time.perf_counter() - t1:.1f} s)")
        check(res.matching_cost == ref.matching_cost, f"migrate step {step}: cost is not scipy's optimum")
    log("[check] plans bit-identical to the plain top-2; migration costs optimal; plans feasible")

    kernels = []
    for name, row, source, replaces in (
        ("lap_bid_batched", lap_rows["fanout"], "src/repro_torch/kernels/csrc/lap_bid.cu",
         "src/repro/kernels/lap_bid.py:149"),
        ("migration_cost", mig_row, "src/repro_torch/kernels/csrc/migration_cost.cu",
         "src/repro/kernels/migration_cost.py:51"),
    ):
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"],
        ))
    return kernels


def main() -> int:
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    if not src.is_dir():
        print(f"chip_smoke: {src} is missing; run from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs the card",
              file=sys.stderr)
        return 3
    smi = nvidia_smi()
    log(f"[env] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    try:
        kernels = run("cuda", FULL)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
