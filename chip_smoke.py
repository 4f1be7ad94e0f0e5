#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``build/kernels``),
holds each against its plain PyTorch version on the card, then drives the
Tesserae round at 2048 GPUs (512 nodes x 4) through the entry points a
user calls — ``TesseraeScheduler.decide`` and ``Simulator.run`` with
``lap_backend="auction_kernel"``, then the same with the fused migrate
stage (``fused_fanout=True``) — and checks what comes out:

1. environment: the card, torch/CUDA versions, the kernels' build time;
2. kernels vs their plain versions at the main path's shapes (exact,
   ``lap_bid_fused_batched`` bit for bit also on non-integer costs), with
   kernel / plain / bound / library times;
3. the round's path: (a) ``decide()`` x3 on 512 synthetic jobs (cold, with
   the previous plan, warm), as the scalability benchmark does, and (b)
   ``Simulator.run(stop_after_rounds=6)`` on a 2048-job shockwave trace
   whose backlog exceeds the cluster, so the packing LAP runs; the launch
   counters are zeroed just before and read just after, and both slice-1
   kernels must have launched.  The fused path: (c) the
   ``fused_decide_scale`` record of ``BENCH_fused_decide.json`` replayed
   (512 jobs, ``fanout_shards=8``, packing off, round 0 then 6 rounds) —
   its per-round bid iterations, dirty pairs, readouts, context host syncs
   and fallbacks must equal the record exactly — and (d) the 2048-job
   simulator run of (b) with ``fused_fanout=True``; counters zeroed before
   (c) and read after (d), and ``lap_bid_fused_batched`` must have
   launched;
4. correctness: (a) re-run with the plain top-2 (``lap_backend="auction"``)
   reproduces every plan and matching cost bit for bit; each migrate step
   re-solved with scipy has the same optimal matching cost, fused steps
   included; the fused steps replayed through
   ``FusedMigrationPlanner(use_kernel=False)`` give bit-identical plans,
   costs and bid iterations; a tie-break run at 8 nodes gives fused plans
   bit-identical to the host scipy planner; every plan is feasible.

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

FULL = dict(
    nodes=512, jobs_decide=512, jobs_sim=2048, sim_rounds=6, fanout=262144,
    fused_rounds=6, fused_shards=8,
    # BENCH_fused_decide.json, record "fused_decide_scale" (counts, not times)
    fused_expect=dict(
        bid_iters=[4751608, 609, 308, 307, 609, 308],
        dirty_pairs=[262144, 0, 0, 0, 0, 0],
    ),
)


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


def compare_lap_bid_fused(shape, device, gen, tb="zero", ties=False, non_integer=False, reps=20):
    """``lap_bid_fused_batched`` against its plain version, bit for bit.
    ``tb``: "zero", "mixed" (0 and ``_tb_scale(n, m)`` on alternate
    instances) or "scale" (``_tb_scale(n, m)`` everywhere)."""
    import torch

    from repro_torch.core.fused import _tb_scale
    from repro_torch.kernels.lap_bid import lap_bid_fused_batched, lap_bid_fused_top2_plain

    b, n, m = shape
    if non_integer:  # off the integer grid the operation order decides every bit
        cost = torch.randn((b, n, m), generator=gen) * 7.0
        p = torch.randn((b, m), generator=gen)
    else:
        cost = torch.randint(0, 65, (b, n, m), generator=gen, dtype=torch.int32).float()
        p = torch.randint(0, 8, (b, m), generator=gen, dtype=torch.int32).float()
    if ties:  # duplicated minima across warp-stride and tile boundaries
        cost[:, 0, [31, 32]] = -50.0
        cost[:, 1 % n, [5, 37, 69 % m]] = -50.0
        cost[:, 2 % n, [511 % m, 512 % m]] = -50.0
        cost[:, 3 % n, :] = 1.0
        p[:] = 0.0
    scale = _tb_scale(n, m)
    tbv = {
        "zero": torch.zeros(b),
        "mixed": torch.where(torch.arange(b) % 2 == 1, scale, 0.0),
        "scale": torch.full((b,), scale),
    }[tb].float()
    cost, p, tbv = (t.to(device).contiguous() for t in (cost, p, tbv))
    got = lap_bid_fused_batched(cost, p, tbv)
    want = lap_bid_fused_top2_plain(cost, p, tbv)
    if device.type == "cuda":
        torch.cuda.synchronize()
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    what = f"lap_bid_fused_batched{shape} tb={tb}{' ties' if ties else ''}{' non-integer' if non_integer else ''}"
    for g, w, out in zip(got, want, ("best_v", "best_j", "second")):
        check(torch.equal(g.view(torch.int32), w.view(torch.int32)), f"{what}: {out} differs from plain (bitwise)")
    # library yardstick: topk of the benefit assembled beforehand (the
    # assembly is NOT in library_ms; the kernel and the plain version do it)
    gi = torch.arange(1, n + 1, device=device, dtype=torch.float32).view(1, n, 1)
    gj = torch.arange(1, m + 1, device=device, dtype=torch.float32).view(1, 1, m)
    vals = (tbv.view(b, 1, 1) * (gi * gi) * gj - cost) - p[:, None, :]
    nbytes = 4 * b * n * m + 4 * b * m + 4 * b + 12 * b * n
    bnd, by = bound_ms(nbytes, 5 * b * n * m, PEAK_F32_OPS_PER_S)
    row = dict(
        shape=list(shape),
        max_abs_err=err,
        ms=graph_ms(lambda: lap_bid_fused_batched(cost, p, tbv), device, reps),
        plain_ms=graph_ms(lambda: lap_bid_fused_top2_plain(cost, p, tbv), device, reps),
        library_ms=graph_ms(lambda: torch.topk(vals, 2, dim=-1), device, reps),
        library_note="torch.topk(vals, 2) of the pre-assembled benefit; assembly excluded",
        bound_ms=bnd,
        bound_by=by,
        eager_ms=timed(lambda: lap_bid_fused_batched(cost, p, tbv), device, reps),
    )
    log(f"[kernel] {what}: bitwise equal to plain; " + json.dumps(row))
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
    build, and keeps the inputs and result of every migrate step, host or
    fused, by wrapping four module functions and ``FusedMigrationPlanner.
    plan`` of the port for the duration of a run.  Each wrapped call
    ends in a device->host readout (the fused program's auctions in one the
    wrapper adds), so its host wall time is the device work's too."""

    def __init__(self):
        import torch

        import repro_torch.core.fused as fused
        import repro_torch.core.matching.engine as engine
        import repro_torch.core.migration as migration
        import repro_torch.core.scheduler as scheduler
        from repro_torch.core.matching import auction
        from repro_torch.kernels.lap_bid import lap_bid_batched, lap_bid_fused_batched

        self.mods = (engine, migration, scheduler, fused)
        self.orig = (
            engine._run_auction, migration._gpu_pair_costs, scheduler.plan_migration,
            fused.FusedMigrationPlanner.plan, fused._pair_auction,
        )
        self.solves = 0
        self.single_column = 0
        self.migrations = []
        #: every fused migrate step: (prev, new_logical, gmap, kwargs, result,
        #: the planner's stats delta)
        self.fused = []
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

        def fused_plan(planner, prev, new_logical, gmap, **k):
            before = dict(planner.stats)
            res = self.orig[3](planner, prev, new_logical, gmap, **k)
            delta = {key: planner.stats[key] - before[key] for key in planner.stats}
            self.fused.append((prev, new_logical, dict(gmap), k, res, delta))
            return res

        def pair_auction(cost, *a, **k):
            # the fused program's auctions (pair chunks, node match); the
            # synchronisations and the read of the iteration counts are the
            # smoke's own, outside the planner's one-readout count
            if cost.is_cuda:
                torch.cuda.synchronize()
            s0, l0, t0 = auction.loop_syncs.count, lap_bid_fused_batched.launches, time.perf_counter()
            out = self.orig[4](cost, *a, **k)
            if cost.is_cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            iters = out[2].cpu()
            self.events.append(dict(
                what="fused_auction", shape=list(cost.shape), wall_s=wall,
                bid_rounds=int(iters.max()), bid_iters=int(iters.sum()),
                converged=bool(out[3].cpu().all()),
                loop_syncs=auction.loop_syncs.count - s0,
                lap_bid_fused_launches=lap_bid_fused_batched.launches - l0,
            ))
            return out

        engine._run_auction = run_auction
        migration._gpu_pair_costs = gpu_pair_costs
        scheduler.plan_migration = plan_migration
        fused.FusedMigrationPlanner.plan = fused_plan
        fused._pair_auction = pair_auction

    def close(self):
        engine, migration, scheduler, fused = self.mods
        (engine._run_auction, migration._gpu_pair_costs, scheduler.plan_migration,
         fused.FusedMigrationPlanner.plan, fused._pair_auction) = self.orig


def check_feasible(plan, gmap, what):
    from repro_torch.core.cluster import EMPTY

    for jid, gpus in plan.job_gpu_map().items():
        check(len(gpus) == gmap[jid], f"{what}: job {jid} holds {len(gpus)} GPUs, wants {gmap[jid]}")
    slots = plan.slots.reshape(-1, plan.slots.shape[-1])
    both = (slots[:, 0] != EMPTY) & (slots[:, 1] != EMPTY)
    check(not (slots[both, 0] == slots[both, 1]).any(), f"{what}: a job packed with itself")


def make_scheduler(cluster, backend, device, **kw):
    from repro_torch.core.policies import TiresiasPolicy
    from repro_torch.core.profiler import ThroughputProfile
    from repro_torch.core.scheduler import TesseraeScheduler

    prof = ThroughputProfile()
    kw.setdefault("enable_packing", True)
    sched = TesseraeScheduler(
        cluster, TiresiasPolicy(prof), prof, lap_backend=backend,
        migration_algorithm="node", device=device, **kw,
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


def run_sim(cluster, device, num_jobs, stop_after, fused=False):
    import torch

    from repro_torch.core.simulator import SimConfig, Simulator
    from repro_torch.core.traces import shockwave_trace
    from repro_torch.kernels.lap_bid import lap_bid_batched, lap_bid_fused_batched
    from repro_torch.kernels.migration_cost import migration_cost

    tag = "sim fused" if fused else "sim"
    sched, prof = make_scheduler(cluster, "auction_kernel", device, fused_fanout=fused)
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
                             "migration_cost": migration_cost.launches,
                             "lap_bid_fused_batched": lap_bid_fused_batched.launches},
            degrade=decision.degrade_reason,
        ))
        hook.seen = len(rec.events)
        log(f"[{tag}] " + json.dumps(rows[-1]))

    hook.seen = 0
    sim = Simulator(cluster, trace, sched, prof, SimConfig(), round_hook=hook)
    t0 = time.perf_counter()
    try:
        res = sim.run(stop_after_rounds=stop_after)
    finally:
        rec.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"[{tag}] {len(rows)} rounds in {time.perf_counter() - t0:.3f} s")
    check(res is None and len(rows) == stop_after,
          f"sim ran {len(rows)} rounds, wanted to pause after {stop_after}")
    return rows, rec


def fused_replay(cluster, device, num_jobs, rounds, shards, expect=None):
    """The ``fused_decide_scale`` replay of ``BENCH_fused_decide.json``
    (``benchmarks/matching_microbench.py --fused``): a static job set,
    packing off, ``fused_fanout=True``; round 0 has no previous plan, then
    ``rounds`` relabelling rounds.  Each round must take one fused readout,
    no context host sync and no host fallback; with ``expect`` its bid
    iterations and dirty pairs must equal the record's exactly."""
    import torch

    from repro_torch.core.matching import auction
    from repro_torch.core.traces import synthetic_active_jobs
    from repro_torch.kernels.lap_bid import lap_bid_fused_batched

    sched, prof = make_scheduler(
        cluster, "auto", device, enable_packing=False, fused_fanout=True, fanout_shards=shards
    )
    jobs = synthetic_active_jobs(num_jobs, seed=1, profile=prof)
    gmap = {j.job_id: j.num_gpus for j in jobs}
    rec = Recorder()
    per_round = []
    try:
        prev = sched.decide(jobs, now=0.0).plan  # round 0: no prev plan, no migrate
        for r in range(1, rounds + 1):
            st0 = dict(sched._fused_planner.stats) if sched._fused_planner else {}
            sync0, ev0 = sched.match_context.stats["host_syncs"], len(rec.events)
            loop0, l0 = auction.loop_syncs.count, lap_bid_fused_batched.launches
            t0 = time.perf_counter()
            d = sched.decide(jobs, now=360.0 * r, prev_plan=prev)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prev = d.plan
            check_feasible(d.plan, gmap, f"fused replay round {r}")
            st = sched._fused_planner.stats

            def delta(k):
                return st[k] - st0.get(k, 0)

            row = dict(
                round=r, decide_s=wall, migrate_s=d.timings["migrate_s"],
                fused_readouts=delta("fused_readouts"),
                context_host_syncs=sched.match_context.stats["host_syncs"] - sync0,
                loop_syncs=auction.loop_syncs.count - loop0,
                dirty_pairs=delta("fused_dirty_pairs"),
                pair_instances=delta("fused_pair_instances"),
                bid_iters=delta("fused_bid_iters"),
                host_fallbacks=delta("fused_host_fallbacks"),
                lap_bid_fused_launches=lap_bid_fused_batched.launches - l0,
                migrations=d.migration.num_migrations,
                matching_cost=d.migration.matching_cost,
                algorithm=d.migration.algorithm,
                steps=rec.events[ev0:],
            )
            per_round.append(row)
            log("[fused replay] " + json.dumps(row))
    finally:
        rec.close()
    for row in per_round:
        r = row["round"]
        check(row["fused_readouts"] == 1, f"fused replay round {r}: {row['fused_readouts']} readouts")
        check(row["context_host_syncs"] == 0, f"fused replay round {r}: context host syncs")
        check(row["host_fallbacks"] == 0, f"fused replay round {r}: host fallback")
        check(row["algorithm"] == "node-fused", f"fused replay round {r}: not served fused")
    if expect is not None:
        for key, want in expect.items():
            got = [row[key] for row in per_round]
            check(got == want, f"fused replay: {key} {got} != BENCH_fused_decide.json {want}")
        log(f"[fused replay] per-round counts equal BENCH_fused_decide.json: {json.dumps(expect)}")
    return per_round, rec


def replay_fused_steps(steps, device, shards, what):
    """Replay recorded fused migrate steps, in order, through a fresh
    ``FusedMigrationPlanner(use_kernel=False)`` (the plain top-2 in the pair
    bid): every plan, node assignment, matching cost and stats delta must
    be bit-identical to the kernel run's."""
    import numpy as np

    from repro_torch.core.fused import FusedMigrationPlanner

    planner = FusedMigrationPlanner(shards=shards, use_kernel=False, device=device)
    t0 = time.perf_counter()
    for i, (prev, new_logical, gmap, kw, res, delta) in enumerate(steps):
        before = dict(planner.stats)
        got = planner.plan(prev, new_logical, gmap, **kw)
        got_delta = {k: planner.stats[k] - before[k] for k in planner.stats}
        check(np.array_equal(got.physical_plan.slots, res.physical_plan.slots),
              f"{what} step {i}: plan differs (fused kernel vs plain top-2)")
        check(np.array_equal(got.node_assignment, res.node_assignment),
              f"{what} step {i}: node assignment differs")
        check(got.matching_cost == res.matching_cost, f"{what} step {i}: matching cost differs")
        check(got_delta == delta, f"{what} step {i}: stats differ {got_delta} vs {delta}")
    log(f"[check] {what}: {len(steps)} fused steps bit-identical with use_kernel=False "
        f"({time.perf_counter() - t0:.1f} s)")


def fused_tie_break_check(device, nodes=8):
    """Fused relabelling with ``tie_break`` at a size inside the f32 budget:
    every plan bit-identical to the host scipy planner's, no fallback."""
    import numpy as np

    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.migration import plan_migration
    from repro_torch.core.traces import synthetic_active_jobs

    sched, prof = make_scheduler(
        ClusterSpec(nodes, 4), "auto", device, enable_packing=False, fused_fanout=True,
        tie_break=True,
    )
    jobs = synthetic_active_jobs(10 * nodes, seed=2, profile=prof)
    rec = Recorder()
    try:
        prev = None
        for i, active in enumerate([jobs, jobs[::2] + jobs[1::4], jobs[1::2], jobs[1::2], jobs]):
            prev = sched.decide(active, now=360.0 * i, prev_plan=prev).plan
    finally:
        rec.close()
    check(len(rec.fused) == 4, f"tie-break run: {len(rec.fused)} fused steps, wanted 4")
    for i, (prev, new_logical, gmap, kw, res, delta) in enumerate(rec.fused):
        host = plan_migration(prev, new_logical, gmap, algorithm="node", backend="scipy",
                              tie_break=True, device=device)
        check(np.array_equal(res.physical_plan.slots, host.physical_plan.slots),
              f"tie-break step {i}: fused plan differs from the host scipy planner's")
        check(res.matching_cost == host.matching_cost, f"tie-break step {i}: cost differs")
        check(delta["fused_host_fallbacks"] == 0, f"tie-break step {i}: host fallback")
    log(f"[check] tie-break at {nodes} nodes: {len(rec.fused)} fused plans bit-identical "
        f"to the host scipy planner, 0 fallbacks")


def run(device, scale):
    import numpy as np
    import torch

    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.migration import plan_migration
    from repro_torch.kernels import build
    from repro_torch.kernels.lap_bid import lap_bid_batched, lap_bid_fused_batched
    from repro_torch.kernels.migration_cost import migration_cost

    counted = {
        "lap_bid_batched": lap_bid_batched,
        "migration_cost": migration_cost,
        "lap_bid_fused_batched": lap_bid_fused_batched,
    }

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counted.items()}

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
    fused_rows = {
        "fanout": compare_lap_bid_fused((scale["fanout"], 4, 4), device, gen, tb="mixed"),
        "node": compare_lap_bid_fused((1, kn, kn), device, gen, tb="zero"),
        "ties": compare_lap_bid_fused((4, 8, 600), device, gen, ties=True, reps=5),
        "non_integer": compare_lap_bid_fused(
            (4096, 4, 4), device, gen, tb="scale", non_integer=True, reps=5
        ),
    }

    # ---- phase 3 (a, b): the round's path ---------------------------------- #
    cluster = ClusterSpec(kn, 4)
    zero_counts()
    t0 = time.perf_counter()
    kernel_rounds, kernel_rec = decide_three(cluster, "auction_kernel", device, scale["jobs_decide"])
    sim_rows, sim_rec = run_sim(cluster, device, scale["jobs_sim"], scale["sim_rounds"])
    launches = read_counts()
    log(f"[main path] {time.perf_counter() - t0:.3f} s; launches {json.dumps(launches)}")
    if device.type == "cuda":  # CPU tensors take the plain versions, uncounted
        check(launches["lap_bid_batched"] > 0, "the main path never launched lap_bid_batched")
        check(launches["migration_cost"] > 0, "the main path never launched migration_cost")

    # ---- phase 3 (c, d): the fused path ------------------------------------ #
    zero_counts()
    t0 = time.perf_counter()
    replay_rows, replay_rec = fused_replay(
        cluster, device, scale["jobs_decide"], scale["fused_rounds"], scale["fused_shards"],
        scale.get("fused_expect"),
    )
    fsim_rows, fsim_rec = run_sim(cluster, device, scale["jobs_sim"], scale["sim_rounds"], fused=True)
    fused_launches = read_counts()
    log(f"[fused path] {time.perf_counter() - t0:.3f} s; launches {json.dumps(fused_launches)}")
    check(fsim_rec.fused, "the fused simulator run never took the fused migrate stage")
    if device.type == "cuda":
        check(fused_launches["lap_bid_fused_batched"] > 0,
              "the fused path never launched lap_bid_fused_batched")

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

    # the fused path: scipy optimum at every fused step, the plain top-2 in
    # the pair bid reproduces every step bit for bit, tie-break parity
    fused_steps = [("fused replay", f) for f in replay_rec.fused] + [
        ("fused sim", f) for f in fsim_rec.fused
    ]
    for step, (where, (prev, new_logical, gmap, kw, res, delta)) in enumerate(fused_steps):
        t1 = time.perf_counter()
        ref = plan_migration(prev, new_logical, gmap, algorithm="node", backend="scipy",
                             down_nodes=kw.get("down_nodes"), speed_factor=kw.get("speed_factor"),
                             device=device)
        log(f"[check] {where} step {step}: fused cost {res.matching_cost} scipy cost "
            f"{ref.matching_cost}; migrations {res.num_migrations} vs {ref.num_migrations}; "
            f"{res.algorithm} ({time.perf_counter() - t1:.1f} s)")
        check(res.matching_cost == ref.matching_cost,
              f"{where} step {step}: cost is not scipy's optimum")
    replay_fused_steps(replay_rec.fused, device, scale["fused_shards"], "fused replay")
    replay_fused_steps(fsim_rec.fused, device, 1, "fused sim")
    fused_tie_break_check(device)

    kernels = []
    for name, row, source, replaces in (
        ("lap_bid_batched", lap_rows["fanout"], "src/repro_torch/kernels/csrc/lap_bid.cu",
         "src/repro/kernels/lap_bid.py:149"),
        ("migration_cost", mig_row, "src/repro_torch/kernels/csrc/migration_cost.cu",
         "src/repro/kernels/migration_cost.py:51"),
        ("lap_bid_fused_batched", fused_rows["fanout"], "src/repro_torch/kernels/csrc/lap_bid.cu",
         "src/repro/kernels/lap_bid.py:343"),
    ):
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name] + fused_launches[name],
            launches_by_path={"round": launches[name], "fused": fused_launches[name]},
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"],
        ))
    kernels[-1]["also_replaces"] = ["src/repro/kernels/lap_bid.py:283"]
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
