#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``build/kernels``),
holds each against its plain PyTorch version on the card, then drives the
Tesserae round at 2048 GPUs (512 nodes x 4) through the entry points a
user calls — ``TesseraeScheduler.decide`` and ``Simulator.run`` with
``lap_backend="auction_kernel"``, then the same with the fused migrate
stage (``fused_fanout=True``) — serves Llama-3-8B at full width and
depth (``transformer.forward`` prefill, ``greedy_generate``), runs the
paper's evaluation harness (``repro_torch.benchmarks.evaluate`` and
``.scalability``), and checks what comes out:

1. environment: the card, torch/CUDA versions, the kernels' build time;
   what ``ptxas`` gave each attention kernel instance (registers, static
   shared memory, spills), and the ``HGMMA`` (wgmma) instructions in the
   SASS of the bf16 ``flash_attention`` instances (``cuobjdump -sass``),
   which must not be zero;
2. kernels vs their plain versions at the main path's shapes (exact,
   ``lap_bid_fused_batched`` bit for bit also on non-integer costs;
   ``lap_auction``, the whole auction in one launch, bit for bit against
   the plain eager loop in every output — the 512x512 node match cold and
   warm, the 262,144 4x4 pair fan-out plain and fused, and after phase 3 the
   largest packing rectangle met — with its time per solve and per bid
   round beside the eager loop's; and past what a CTA's shared memory
   holds, the wide plan (one CTA per instance): 1x8x6000 and 1x64x6000,
   a 6000x6000 warm start, and one ``solve_lap_batched(backend=
   "auction_kernel")`` at 64x6000 with scipy's cost;
   ``flash_attention`` and ``flash_decode`` in bf16 at 3e-2 and within 1e-2
   relative L2 error per 128-query tile / per head, at the serving path's
   shapes and at ``prefill_32k`` / ``decode_32k``'s length), with
   kernel / plain / bound / library times (and, for the attention kernels,
   the share of the bound and the ratio to the library call); a causal
   ``sdpa`` at head dim 192 (no flash instance) runs the einsum path on the
   card, equal to the CPU's at 2e-5, and raises under ``REPRO_USE_FLASH=1``;
3. the round's path: (a) ``decide()`` x3 on 512 synthetic jobs (cold, with
   the previous plan, warm), as the scalability benchmark does, and (b)
   ``Simulator.run(stop_after_rounds=6)`` on a 2048-job shockwave trace
   whose backlog exceeds the cluster, so the packing LAP runs; the launch
   counters are zeroed just before and read just after: ``lap_auction``
   and ``migration_cost`` must have launched, every auction solve that
   asked for the kernel launched ``lap_auction`` once with no host sync
   (``loop_syncs`` 0), and the node match and the pair fan-out were among
   them.  The fused path: (c) the
   ``fused_decide_scale`` record of ``BENCH_fused_decide.json`` replayed
   (512 jobs, ``fanout_shards=8``, packing off, round 0 then 6 rounds) —
   its per-round bid iterations, dirty pairs, readouts, context host syncs
   and fallbacks must equal the record exactly — and (d) the 2048-job
   simulator run of (b) with ``fused_fanout=True``; counters zeroed before
   (c) and read after (d), with the same checks of ``lap_auction`` over the
   fused program's auctions (each pair chunk and the node match);
4. correctness: (a) re-run with the plain top-2 (``lap_backend="auction"``)
   reproduces every plan and matching cost bit for bit; each migrate step
   re-solved with scipy has the same optimal matching cost, fused steps
   included; the fused steps replayed through
   ``FusedMigrationPlanner(use_kernel=False)`` give bit-identical plans,
   costs and bid iterations; a tie-break run at 8 nodes gives fused plans
   bit-identical to the host scipy planner; every plan is feasible;
5. serving ``llama3-8b`` (32 layers, bf16, random weights from a seeded
   ``torch.Generator`` on the card, freed after the phase): (e) a prefill
   forward of 8192 random tokens on the flash branch (sdpa's default on
   CUDA; K6 launched once per layer), each layer's K6 output held to the
   plain version on that layer's q/k/v (3e-2; 1e-2 relative per query
   tile), and the einsum path's
   forward; (f) ``greedy_generate`` with batch 8, a 32-token prompt and 32
   new tokens against an 8192-slot cache, and one forward of the 64
   tokens; then K7 launched on layer 0's final cache with the last step's q
   (valid_len 63) and held to its plain version (3e-2; 1e-2 relative per
   head) and to the einsum ``sdpa`` (3e-2).  The whole-model comparisons — flash forward vs einsum forward,
   stepped logits vs the forward's — are enforced on the same weights
   upcast to f32 (1e-4); in bf16 they are reported with each path's
   distance from the f32 forward (at depth 32 bf16 rounding alone moves
   logits by up to ~0.08, the einsum path's as much as the flash path's).
   Counters zeroed before (e) and read after: K6 must have launched once
   per layer of every flash forward, K7 once;
6. the evaluation harness on the card: (g) ``BENCH_endtoend.json``'s
   sweep (5 policies x 8 scenarios, 48 GPUs, 100 jobs, seed 0, ``auto``):
   every arm's metrics, faults and matching telemetry, and the derived
   speedups, equal to the record exactly (wall times excluded), K5
   launched — except that a Gavel arm may follow this host's scipy to
   another optimal vertex of its degenerate LP, and must then equal the
   same arm on this host's CPU exactly (printed, with the fields); the 8 ``tesserae-t`` arms again under ``auction_kernel``
   (every kernel solve one ``lap_auction`` launch, no host sync), each
   printed beside its ``auto`` arm, and two of them on the CPU as twins that
   must equal the card's arms in every decision field; (h) the scalability
   benchmark's Part 1 (128 to 2048 active jobs on 256 GPUs, ``auto`` and
   ``auction_kernel``; the 2048-job cold and warm ``decide()`` printed
   beside the paper's 1.6 s, not gated) and Part 2 (256 to 2048 GPUs, scipy
   and ``auction_kernel``): every plan feasible, every migrate step not
   solved by scipy at scipy's optimal cost.  Counters zeroed before (g) and
   before (h) and read after each.

Any failure exits non-zero.  The last three lines are the kernels JSON,
the card's ``name, power.limit`` and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM peaks (data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
PEAK_F64_OPS_PER_S = 34e12  # f64 outside the tensor cores (data sheet)
PEAK_BF16_OPS_PER_S = 989e12  # bf16 tensor cores, dense (data sheet)

FULL = dict(
    nodes=512, jobs_decide=512, jobs_sim=2048, sim_rounds=6, fanout=262144,
    fused_rounds=6, fused_shards=8,
    # BENCH_fused_decide.json, record "fused_decide_scale" (counts, not times)
    fused_expect=dict(
        bid_iters=[4751608, 609, 308, 307, 609, 308],
        dirty_pairs=[262144, 0, 0, 0, 0, 0],
    ),
    # phase 5: serving llama3-8b at full width and depth (bf16)
    serve=dict(
        arch="llama3-8b", reduced=False, prefill_s=8192, batch=8, prompt=32, gen=32,
        context=8192,
        # kernel rows: (B, S, H, KV, D) for flash_attention, (B, S, H, KV, D,
        # valid) for flash_decode; the first of each is the path's shape
        k6_shapes=[(1, 8192, 32, 8, 128), (1, 32768, 32, 8, 128)],
        k7_shapes=[(8, 8192, 32, 8, 128, 63), (32, 32768, 32, 8, 128, 32768)],
    ),
    # phase 6: BENCH_endtoend.json's whole sweep, and the scalability
    # benchmark's Part 1 (256 GPUs) and Part 2 (up to 2048 GPUs)
    wide_square=True,
    evaluate=dict(twins=("poisson-steady", "philly-failures")),
    scalability=dict(job_counts=[128, 512, 1024, 2048], clusters=[(64, 4), (256, 4), (512, 4)]),
)

#: the CPU rehearsal's phase 6: four arms of the record, a 64-GPU Part 2
EVAL_REHEARSAL = dict(policies=("tesserae-t", "tiresias"),
                      scenarios=("poisson-steady", "philly-failures"), twins=("philly-failures",))
SCALABILITY_REHEARSAL = dict(job_counts=[128], clusters=[(16, 4)])

#: the CPU rehearsal's serve scale (reduced llama3-8b, S = 64)
SERVE_REHEARSAL = dict(
    arch="llama3-8b", reduced=True, prefill_s=64, batch=2, prompt=8, gen=8, context=64,
    k6_shapes=[(1, 64, 4, 2, 64)], k7_shapes=[(2, 64, 4, 2, 64, 15)],
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


def graph_ms(fn, device, reps=20, replays=5, warmup=3):
    """Mean DEVICE milliseconds per call of ``fn``: ``reps`` calls captured
    in one CUDA graph and replayed, so the host's per-call dispatch (the
    wrapper's checks, allocation and ctypes call) is not in the time."""
    import torch

    if device.type != "cuda":  # CPU rehearsal only; never reported
        return timed(fn, device, reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
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


def auction_start(a, *, rect=False, warm=False, tb=None):
    """The prologue ``core/matching/auction.py`` computes once per solve, as
    per-instance tensors: ``(eps0, eps_min, thr)``.  ``tb`` (the fused
    pairs): ``eps_min = (tb or 1) / (n + 1)`` as the fused stage sets it."""
    import numpy as np
    import torch

    b, n, m = a.shape
    one = torch.ones(b, device=a.device)
    eps_min = (one if tb is None else torch.where(tb > 0, tb, one)) / (n + 1)
    if rect:
        return eps_min, eps_min, torch.full_like(eps_min, float("inf"))
    thr = eps_min * np.float32(1 + 1e-6)
    span = torch.clamp_min(a.abs().amax(dim=(1, 2)), 1.0)
    eps0 = eps_min if warm else torch.maximum(span / 4.0, eps_min)
    return eps0, eps_min, thr


def compare_lap_auction(what, a, device, *, p0=None, col0=None, rect=False, warm=False, tb=None,
                        neg=-1e30, reps=3, warmup=1, max_iters=20_000, one_cta=False):
    """``lap_auction`` (one launch per solve) against ``lap_auction_plain``
    (the eager loop) on the same inputs, bit for bit in every output, with
    the time per solve and per bid round of each.  Returns ``(row, (col_of,
    prices, iters, eps))``.  ``one_cta``: also time the solve on a plan of
    one CTA reading the rows from L2 (the design's alternative)."""
    import torch

    from repro_torch.kernels import lap_auction as la

    b, n, m = a.shape
    p0 = torch.zeros((b, m), device=device) if p0 is None else p0
    col0 = torch.full((b, n), -1, dtype=torch.int64, device=device) if col0 is None else col0
    eps0, eps_min, thr = auction_start(a, rect=rect, warm=warm, tb=tb)
    args = (a, p0, col0, eps0, eps_min, thr, max_iters)
    kw = dict(tb=tb, neg=neg)
    got = la.lap_auction(*args, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = la.lap_auction_plain(*args, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for g, w, out in zip(got, want, ("col_of", "prices", "iters", "eps")):
        same = (torch.equal(g.view(torch.int32), w.view(torch.int32)) if g.dtype == torch.float32
                else torch.equal(g, w))
        check(same, f"lap_auction {what} {tuple(a.shape)}: {out} differs from plain (bitwise)")
    iters = got[2].long()
    rounds = int(iters.max())
    nbytes = 4 * (b * n * m + 2 * b * m + 2 * b * n + 5 * b) + (4 * b if tb is not None else 0)
    # the least work these inputs need: one row's top-2 over m columns per round
    bnd, by = bound_ms(nbytes, 3 * m * int(iters.sum()), PEAK_F32_OPS_PER_S)
    row = dict(
        case=what, shape=list(a.shape), max_abs_err=0.0, rounds=rounds, rounds_sum=int(iters.sum()),
        converged=bool(((got[0] >= 0).all(dim=1) & (got[3] <= thr)).all()),
        plan=la.launch_plan(b, n, m)._asdict(),
        ms=timed(lambda: la.lap_auction(*args, **kw), device, reps, warmup),
        plain_ms=plain_ms, library_ms=None, bound_ms=bnd, bound_by=by,
    )
    row["ms_per_round"] = row["ms"] / max(rounds, 1)
    row["plain_ms_per_round"] = plain_ms / max(rounds, 1)
    if one_cta:
        plan = la.AuctionPlan("cluster", 0, 1, n, la.CLUSTER_THREADS, b,
                              la.cluster_smem(m, n, False), False)
        alt = la.lap_auction(*args, **kw, plan=plan)
        check(all(torch.equal(x, y) for x, y in zip(alt, got)),
              f"lap_auction {what}: the one-CTA plan differs")
        row["one_cta_ms"] = timed(lambda: la.lap_auction(*args, **kw, plan=plan), device, reps, 1)
    log(f"[kernel] lap_auction {what} {tuple(a.shape)}: bitwise equal to the plain loop; "
        + json.dumps(row))
    return row, got


def auction_rows(kn, fanout, device, gen):
    """Phase 2's ``lap_auction`` cases at the main path's shapes: the node
    match cold and warm from the cold solve's prices, the pair fan-out on
    the plain bid (the ``auction_kernel`` backend) and fused (tb mixed), and
    the fused assembly on non-integer costs."""
    import torch

    from repro_torch.core.fused import _tb_scale

    a = torch.randint(-64, 1, (1, kn, kn), generator=gen, dtype=torch.int32).float().to(device)
    rows = {}
    rows["node_cold"], cold = compare_lap_auction("node cold", a, device, one_cta=True)
    a2 = a + torch.randint(-2, 3, a.shape, generator=gen, dtype=torch.int32).float().to(device)
    rows["node_warm"], _ = compare_lap_auction("node warm", a2, device, p0=cold[1], warm=True)
    fan = torch.randint(-64, 1, (fanout, 4, 4), generator=gen, dtype=torch.int32).float().to(device)
    rows["fanout"], _ = compare_lap_auction("fan-out", fan, device)
    cost = torch.randint(0, 65, (fanout, 4, 4), generator=gen, dtype=torch.int32).float().to(device)
    tb = torch.where(torch.arange(fanout, device=device) % 2 == 1, _tb_scale(4, 4), 0.0).float()
    rows["fanout_fused"], _ = compare_lap_auction("fused fan-out tb mixed", cost, device, tb=tb)
    noisy = (torch.randn((4096, 4, 4), generator=gen) * 7.0).to(device)
    rows["fused_non_integer"], _ = compare_lap_auction(
        "fused non-integer", noisy, device, tb=torch.full((4096,), _tb_scale(4, 4), device=device))
    rows["node_plain_sentinel"], _ = compare_lap_auction("node, plain sentinel", a, device,
                                                         neg=-1e18)
    return rows


def wide_rows(device, gen, square=True):
    """P1: ``lap_auction`` past what a CTA's shared memory holds (the wide
    plan, one CTA per instance with its column state in global memory), bit
    for bit against the plain loop: two rectangles whose rows compete for
    one column preference, a square warm start with 256 rows free, and the
    first round of a square cold start, where every row bids (``square=
    False`` leaves the squares out, as the CPU rehearsal does).  Then one ``solve_lap_batched(backend=
    "auction_kernel")`` at that width, whose cost must be scipy's."""
    import numpy as np
    import torch

    from repro_torch.core.matching import solve_lap_batched
    from repro_torch.kernels import lap_auction as la

    m = 6000  # past the 5,784 columns a CTA's shared memory holds the state of
    rows = {}
    for n in (8, 64):
        a = (torch.randint(0, 50, (1, 1, m), generator=gen, dtype=torch.int32)
             + torch.randint(-3, 4, (1, n, m), generator=gen, dtype=torch.int32)).float().to(device)
        check(la.launch_plan(1, n, m).regime == "wide", f"1x{n}x{m} does not take the wide plan")
        rows[f"wide_rect_{n}"], _ = compare_lap_auction(f"wide rect {n}x{m}", a, device, rect=True,
                                                        neg=-1e18)
    if square:
        a = torch.randint(-64, 1, (1, m, m), generator=gen, dtype=torch.int32).float()
        perm = torch.randperm(m, generator=gen)
        a[0, torch.arange(m), perm] += 8.0
        col0 = perm.view(1, m).clone()
        col0[0, torch.randperm(m, generator=gen)[:256]] = -1
        check(la.launch_plan(1, m, m).regime == "wide", f"1x{m}x{m} does not take the wide plan")
        a = a.to(device)
        rows["wide_square_warm"], _ = compare_lap_auction(
            "wide square warm, 256 rows free", a, device, col0=col0.to(device), warm=True,
            neg=-1e18, reps=1, warmup=0)
        # the round a cold phase starts with: every row bids
        rows["wide_square_cold_round"], _ = compare_lap_auction(
            "wide square cold, its first round", a, device, neg=-1e18, reps=1, warmup=0,
            max_iters=1)
        del a
    costs = -(torch.randint(0, 50, (1, 1, m), generator=gen, dtype=torch.int32)
              + torch.randint(-3, 4, (1, 64, m), generator=gen, dtype=torch.int32)).double().numpy()
    before = la.lap_auction.launches
    t0 = time.perf_counter()
    got = solve_lap_batched(costs, backend="auction_kernel", device=device)
    wall = time.perf_counter() - t0
    want = solve_lap_batched(costs, backend="scipy", device=device)
    launched = la.lap_auction.launches - before
    check(not got.used_fallback.any() and np.array_equal(got.total_cost, want.total_cost),
          f"solve_lap_batched(auction_kernel) at 64x{m}: cost {got.total_cost} vs scipy's "
          f"{want.total_cost} (fallback {got.used_fallback})")
    if device.type == "cuda":
        check(launched == 1, f"solve_lap_batched at 64x{m} launched lap_auction {launched} times")
    rows["wide_engine"] = dict(case=f"solve_lap_batched auction_kernel 64x{m}", shape=[1, 64, m],
                               cost=float(got.total_cost[0]), scipy_cost=float(want.total_cost[0]),
                               bid_rounds=int(got.bid_iters[0]), wall_ms=wall * 1e3)
    log(f"[kernel] {rows['wide_engine']['case']}: cost {got.total_cost[0]} equals scipy's; "
        + json.dumps(rows["wide_engine"]))
    return rows


def check_flash_routing(device):
    """P2: unset ``REPRO_USE_FLASH``, a causal ``sdpa`` at a head dim the
    flash kernel has no instance for runs the einsum path on the card and
    matches the CPU's einsum path (2e-5, f32); ``REPRO_USE_FLASH=1`` asks for
    the kernel there and raises."""
    import torch

    import repro_torch.kernels.flash_attention as fa
    from repro_torch.models.attention import sdpa

    d = 192  # nemotron-4-340b's head dim
    saved = os.environ.pop("REPRO_USE_FLASH", None)
    try:
        gen = torch.Generator().manual_seed(5)
        q, k, v = (torch.randn((1, 512, h, d), generator=gen) for h in (8, 2, 2))
        want = sdpa(q, k, v, causal=True)
        before = fa.flash_attention.launches
        got = sdpa(q.to(device), k.to(device), v.to(device), causal=True).cpu()
        check(fa.flash_attention.launches == before, f"sdpa at head dim {d} launched the flash kernel")
        err = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5)),
              f"sdpa at head dim {d} on {device} differs from the CPU's einsum path ({err})")
        raised = None
        if device.type == "cuda":
            os.environ["REPRO_USE_FLASH"] = "1"
            try:
                sdpa(q.to(device), k.to(device), v.to(device), causal=True)
            except ValueError as exc:
                raised = str(exc)
            check(raised is not None and f"head dim {d}" in raised,
                  f"REPRO_USE_FLASH=1 at head dim {d} did not raise")
    finally:
        os.environ.pop("REPRO_USE_FLASH", None)
        if saved is not None:
            os.environ["REPRO_USE_FLASH"] = saved
    row = dict(head_dim=d, shape=[1, 512, 8, 2, d], max_abs_err=err, forced_raises=raised)
    log(f"[check] sdpa at head dim {d}, env unset: the einsum path on {device}, max err {err:.3g} "
        f"vs the CPU's; REPRO_USE_FLASH=1 raises: {raised}")
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


def logits_stats(a, b, tol, chunk=512):
    """How far logits ``a`` are from ``b`` (both (B, S, V)): the max |a - b|,
    how many entries break ``|a - b| <= tol + tol * |b|``, how many differ
    by more than 0.01 / 0.02, and the share of positions whose argmax
    agrees.  Computed in f32 a chunk of positions at a time."""
    st = dict(max_abs_err=0.0, over_tol=0, over_0p01=0, over_0p02=0, argmax_agree=0,
              positions=a.shape[0] * a.shape[1], entries=a.numel())
    for i in range(0, a.shape[1], chunk):
        x, y = a[:, i:i + chunk].float(), b[:, i:i + chunk].float()
        diff = (x - y).abs()
        st["max_abs_err"] = max(st["max_abs_err"], float(diff.max()))
        st["over_tol"] += int((diff > tol + tol * y.abs()).sum())
        st["over_0p01"] += int((diff > 0.01).sum())
        st["over_0p02"] += int((diff > 0.02).sum())
        st["argmax_agree"] += int((x.argmax(-1) == y.argmax(-1)).sum())
    st["argmax_agree"] /= st["positions"]
    return st


def logits_close(a, b, tol):
    """(max |a - b|, all |a - b| <= tol + tol * |b|) of two (B, S, ...) tensors."""
    st = logits_stats(a, b, tol)
    return st["max_abs_err"], st["over_tol"] == 0


#: the attention kernels' error scaled to their output: the largest relative
#: L2 error of a 128-query tile (K6) or of one head's output (K7).  The
#: 3e-2 check alone is as large as a typical output at long lengths, where
#: a uniform-ish softmax makes |out| ~ sqrt(1 / length).
REL_TOL = 1e-2


def rel_err(got, want, group=1):
    """The largest ``||got - want|| / ||want||`` (f32, L2) over groups of
    ``group`` consecutive indices of dim 1 of (B, N, ...) tensors, per
    batch row; 0 where both are zero."""
    import torch.nn.functional as F

    b, n = got.shape[:2]
    d2 = (got.float() - want.float()).square().reshape(b, n, -1).sum(-1)
    w2 = want.float().square().reshape(b, n, -1).sum(-1)
    pad = (-n) % group
    d2, w2 = (F.pad(x, (0, pad)).reshape(b, -1, group).sum(-1) for x in (d2, w2))
    return float((d2 / w2.clamp_min(1e-30)).sqrt().max())


def compare_flash_attention(shape, device, seed, long=False):
    """``flash_attention`` (K6) against its plain version on random bf16
    q (B, S, H, D) and k/v (B, S, KV, D), causal, at 3e-2 and, per
    128-query tile, within ``REL_TOL`` relative L2 error."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    b, s, h, kv, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*sh):
        return torch.randn(sh, generator=gen, device=device).to(torch.bfloat16)

    q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    err, ok = logits_close(got.reshape(b, s, -1), want.reshape(b, s, -1), 3e-2)
    check(ok, f"flash_attention {shape}: differs from plain beyond 3e-2 (max {err})")
    rel = rel_err(got, want, 128)
    check(rel <= REL_TOL, f"flash_attention {shape}: a query tile's relative error {rel} > {REL_TOL}")

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True,
        )

    lib_err = None
    if not long:  # the yardstick computes the same function
        lib_err, lib_ok = logits_close(library().transpose(1, 2).reshape(b, s, -1),
                                       want.reshape(b, s, -1), 3e-2)
        check(lib_ok, f"flash_attention {shape}: scaled_dot_product_attention disagrees ({lib_err})")
    del got, want
    g = dict(reps=2, replays=1, warmup=1) if long else dict(reps=5, replays=2, warmup=2)
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d)  # q, out; k, v (bf16)
    ops = 4 * b * h * s * s * d // 2  # causal: half of the S x S products
    bnd, by = bound_ms(nbytes, ops, PEAK_BF16_OPS_PER_S)
    row = dict(
        shape=list(shape), dtype="bfloat16", causal=True, max_abs_err=err, rel_err=rel,
        library_err=lib_err,
        ms=graph_ms(lambda: flash_attention(q, k, v, causal=True), device, **g),
        eager_ms=timed(lambda: flash_attention(q, k, v, causal=True), device, g["reps"], 1),
        plain_ms=timed(lambda: flash_attention_plain(q, k, v, causal=True), device, 1, 1),
        library_ms=graph_ms(library, device, **g),
        library_note="scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
        bound_ms=bnd, bound_by=by, ops=ops, bytes=nbytes,
    )
    row["tflops"] = ops / row["ms"] / 1e9
    row.update(share_of_bound=bnd / row["ms"], x_library=row["ms"] / row["library_ms"])
    log(f"[kernel] flash_attention {shape}: within 3e-2 of plain, worst tile's relative error "
        f"{rel:.3g} (limit {REL_TOL}); " + json.dumps(row))
    return row


def compare_flash_decode(shape, device, seed):
    """``flash_decode`` (K7) against its plain version on a random bf16
    cache (B, S, KV, D), ``valid_len`` slots valid, at 3e-2 and, per head,
    within ``REL_TOL`` relative L2 error."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain, splits_for

    b, s, h, kv, d, valid = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*sh):
        return torch.randn(sh, generator=gen, device=device).to(torch.bfloat16)

    q, k, v = rand(b, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    got = flash_decode(q, k, v, valid)
    want = flash_decode_plain(q, k, v, valid)
    err, ok = logits_close(got, want, 3e-2)
    check(ok, f"flash_decode {shape}: differs from plain beyond 3e-2 (max {err})")
    rel = rel_err(got, want)
    check(rel <= REL_TOL, f"flash_decode {shape}: a head's relative error {rel} > {REL_TOL}")
    mask = (torch.arange(s, device=device) < valid)[None, None, None, :]

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )

    lib_err, lib_ok = logits_close(library()[:, :, 0], want, 3e-2)
    check(lib_ok, f"flash_decode {shape}: scaled_dot_product_attention disagrees ({lib_err})")
    nbytes = 2 * (2 * b * valid * kv * d + 2 * b * h * d)  # valid K, V slots; q, out
    ops = 4 * b * h * valid * d
    bnd, by = bound_ms(nbytes, ops, PEAK_BF16_OPS_PER_S)
    g = dict(reps=10, replays=3)
    row = dict(
        shape=list(shape), dtype="bfloat16", max_abs_err=err, rel_err=rel, library_err=lib_err,
        splits=list(splits_for(b * kv, s)),
        ms=graph_ms(lambda: flash_decode(q, k, v, valid), device, **g),
        eager_ms=timed(lambda: flash_decode(q, k, v, valid), device, 10, 2),
        plain_ms=timed(lambda: flash_decode_plain(q, k, v, valid), device, 3, 1),
        library_ms=graph_ms(library, device, **g),
        library_note="scaled_dot_product_attention(boolean mask, enable_gqa=True)",
        bound_ms=bnd, bound_by=by, ops=ops, bytes=nbytes,
    )
    row["gb_per_s"] = nbytes / row["ms"] / 1e6
    row.update(share_of_bound=bnd / row["ms"], x_library=row["ms"] / row["library_ms"])
    log(f"[kernel] flash_decode {shape}: within 3e-2 of plain, worst head's relative error "
        f"{rel:.3g} (limit {REL_TOL}); " + json.dumps(row))
    return row


# --------------------------------------------------------------------------- #
# phase 5: serving llama3-8b
# --------------------------------------------------------------------------- #
def profile_window(fn, device, top=8):
    """Run ``fn`` once under ``torch.profiler`` and return its host wall
    time, the device's kernel time and busy share over that wall, and the
    ``top`` kernels by device time.  A measurement only: a profiler that
    fails is reported, not fatal."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the kernels themselves (the host ops above them carry their
        # kernels' device time too, and would count it twice)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    except Exception as exc:  # noqa: BLE001 - reported with the row
        return dict(error=f"{type(exc).__name__}: {exc}")
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return dict(
        wall_ms=wall * 1e3, device_ms=busy_us / 1e3,
        busy_share=busy_us / 1e3 / (wall * 1e3) if wall > 0 else None,
        top=[dict(name=e.key[:80], calls=e.count, ms=e.self_device_time_total / 1e3)
             for e in kernels[:top]],
    )


def _upcast(tree):
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_upcast(v) for v in tree]
    return tree.float()


def serve_phase(device, scale):
    """Serve ``llama3-8b`` in bf16 on random weights: (e) a prefill forward
    on the flash branch (sdpa's default on CUDA), each layer's K6 output held
    to the plain version on that layer's own q/k/v (3e-2), and the einsum
    path's forward (``REPRO_USE_FLASH=0``); (f) ``greedy_generate`` (prefill
    by stepping, greedy decode) and one forward of the generated tokens; K7
    launched on layer 0's final cache with the last step's q, held to its
    plain version and to the einsum ``sdpa`` (3e-2).

    The whole-model comparisons are enforced on the same weights upcast to
    f32, where rounding does not swamp them: the flash forward against the
    einsum forward, and the stepped logits against the forward's, at 1e-4.
    In bf16 the two paths of a 32-layer model differ by up to ~0.08 — as far
    as the einsum path itself is from the f32 forward — so the bf16
    comparisons (with each path's distance from the f32 forward) are
    reported, not enforced."""
    import collections
    import os

    import torch

    import repro_torch.kernels.flash_attention as fa
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    from repro_torch.models import get_model
    from repro_torch.serve import ServeConfig, greedy_generate, init_serving_cache, make_serve_step

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    cfg = (get_reduced if scale["reduced"] else get_config)(scale["arch"])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = get_model(cfg)
    out = dict(model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, dtype=cfg.dtype,
               param_count=cfg.param_count(), flash_forwards=0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0), cfg)
    sync()
    out["init_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        out["weights_gb"] = torch.cuda.memory_allocated() / 1e9
    # on the card the flash branch is sdpa's default; the CPU rehearsal forces it
    flash_env = None if device.type == "cuda" else "1"
    saved_env = os.environ.get("REPRO_USE_FLASH")

    def set_flash(value):
        if value is None:
            os.environ.pop("REPRO_USE_FLASH", None)
        else:
            os.environ["REPRO_USE_FLASH"] = value

    def forward(p, c, tokens, flash=True):
        set_flash(flash_env if flash else "0")
        out["flash_forwards"] += int(flash)
        sync()
        t = time.perf_counter()
        logits, _ = model.forward(p, c, {"tokens": tokens})
        sync()
        check(bool(torch.isfinite(logits).all()), f"{c.dtype} forward: logits are not finite")
        return logits, time.perf_counter() - t

    gen = torch.Generator(device=device).manual_seed(1)
    orig_sdpa = attention.sdpa
    try:
        # ---- (e) prefill ---------------------------------------------------- #
        s = scale["prefill_s"]
        tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=device)
        logits, out["prefill_s"] = forward(params, cfg, tokens)
        out["prefill_tokens_per_s"] = s / out["prefill_s"]
        check(tuple(logits.shape) == (1, s, cfg.vocab_size), f"prefill logits {tuple(logits.shape)}")

        layer_errs = []

        def checked_sdpa(q, k, v, causal, q_offset=None, kv_valid_len=None):
            res = orig_sdpa(q, k, v, causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
            want = fa.flash_attention_plain(q, k, v, causal)
            b_, s_ = q.shape[:2]
            layer_errs.append((*logits_close(res.reshape(b_, s_, -1), want.reshape(b_, s_, -1), 3e-2),
                               rel_err(res, want, 128)))
            return res

        attention.sdpa = checked_sdpa
        launches0 = fa.flash_attention.launches
        again, _ = forward(params, cfg, tokens)
        attention.sdpa = orig_sdpa
        check(len(layer_errs) == cfg.num_layers,
              f"prefill: attention ran in {len(layer_errs)} of {cfg.num_layers} layers")
        if device.type == "cuda":
            check(fa.flash_attention.launches - launches0 == cfg.num_layers,
                  "prefill: the flash kernel did not run in every layer")
        for i, (err, ok, rel) in enumerate(layer_errs):
            check(ok, f"prefill layer {i}: flash_attention differs from plain beyond 3e-2 ({err})")
            check(rel <= REL_TOL, f"prefill layer {i}: a query tile's relative error {rel} > {REL_TOL}")
        out["prefill_layer_max_err"] = max(err for err, _, _ in layer_errs)
        out["prefill_layer_max_rel_err"] = max(rel for _, _, rel in layer_errs)
        check(torch.equal(again, logits), "prefill: two flash forwards differ")
        del again
        einsum_logits, out["prefill_einsum_s"] = forward(params, cfg, tokens, flash=False)
        out["bf16_prefill_vs_einsum"] = logits_stats(logits, einsum_logits, 0.05)

        # ---- (f) greedy serving --------------------------------------------- #
        b, p, n = scale["batch"], scale["prompt"], scale["gen"]
        prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device=device)
        sc = ServeConfig(batch_size=b, context_len=scale["context"])
        captured = collections.deque(maxlen=cfg.num_layers)  # the last step's layers

        def recording_sdpa(q, k, v, causal, q_offset=None, kv_valid_len=None):
            res = orig_sdpa(q, k, v, causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
            if kv_valid_len is not None:
                captured.append((q, k, v, kv_valid_len, res))
            return res

        attention.sdpa = recording_sdpa
        set_flash(flash_env)
        sync()
        t0 = time.perf_counter()
        seq, step_logits = greedy_generate(params, cfg, prompt, n, sc, return_logits=True)
        sync()
        attention.sdpa = orig_sdpa
        steps = p + n - 1
        out.update(generate_s=time.perf_counter() - t0, steps=steps, batch=b,
                   cache_len=sc.cache_len(cfg))
        out["step_ms"] = out["generate_s"] / steps * 1e3
        out["decode_tokens_per_s"] = b * steps / out["generate_s"]
        check(tuple(seq.shape) == (b, p + n), f"generated {tuple(seq.shape)}")
        check(bool(torch.isfinite(step_logits).all()), "stepped logits are not finite")
        full, _ = forward(params, cfg, seq)
        out["bf16_decode_vs_forward"] = logits_stats(step_logits, full[:, :-1], 0.05)
        del full

        # where the time goes: one prefill forward and three decode steps
        out["profile_prefill"] = profile_window(lambda: forward(params, cfg, tokens), device)
        cache = init_serving_cache(cfg, sc, device)
        serve_step = make_serve_step(cfg)
        out["profile_decode_3_steps"] = profile_window(
            lambda: [serve_step(params, seq[:, i:i + 1], cache, i) for i in range(steps - 3, steps)],
            device,
        )
        del cache

        q, k, v, valid, einsum_out = captured[0]  # layer 0 of the last step
        check(valid == steps, f"last step's valid_len {valid}, wanted {steps}")
        got = flash_decode(q[:, 0], k, v, valid)
        want = flash_decode_plain(q[:, 0], k, v, valid)
        err_plain, ok_plain = logits_close(got, want, 3e-2)
        rel_plain = rel_err(got, want)
        err_sdpa, ok_sdpa = logits_close(got, einsum_out[:, 0], 3e-2)
        check(ok_plain, f"flash_decode on the served cache differs from plain ({err_plain})")
        check(rel_plain <= REL_TOL, f"flash_decode on the served cache: a head's relative error "
              f"{rel_plain} > {REL_TOL}")
        check(ok_sdpa, f"flash_decode on the served cache differs from sdpa ({err_sdpa})")
        out.update(k7_valid_len=valid, k7_vs_plain_max_err=err_plain, k7_vs_plain_rel_err=rel_plain,
                   k7_vs_sdpa_max_err=err_sdpa)
        del captured, q, k, v, einsum_out, got, want

        # ---- the whole-model checks, on the same weights in f32 ------------- #
        params32 = _upcast(params)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref, _ = forward(params32, cfg32, tokens, flash=False)
        out["bf16_prefill_flash_vs_f32"] = logits_stats(logits, ref, 0.05)
        out["bf16_prefill_einsum_vs_f32"] = logits_stats(einsum_logits, ref, 0.05)
        del logits, einsum_logits
        flash32, _ = forward(params32, cfg32, tokens)
        st = logits_stats(flash32, ref, 1e-4)
        out["f32_prefill_vs_einsum"] = st
        check(st["over_tol"] == 0, f"f32 prefill: flash logits differ from the einsum path's beyond 1e-4 ({st})")
        del flash32, ref
        set_flash(flash_env)
        seq32, steps32 = greedy_generate(params32, cfg32, prompt, n, sc, return_logits=True)
        check(torch.equal(seq32[:, :p], prompt), "f32 serving lost the prompt")
        full32, _ = forward(params32, cfg32, seq32)
        st = logits_stats(steps32, full32[:, :-1], 1e-4)
        out["f32_decode_vs_forward"] = st
        check(st["over_tol"] == 0, f"f32 decode parity: stepped logits differ from the forward's beyond 1e-4 ({st})")
        if torch.equal(seq32, seq):
            out["bf16_steps_vs_f32_forward"] = logits_stats(step_logits, full32[:, :-1], 0.05)
        del full32, steps32, step_logits, params32
    finally:
        attention.sdpa = orig_sdpa
        set_flash(saved_env)
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
    log(f"[serve] {cfg.name} prefill S={s}: per-layer K6 max err {out['prefill_layer_max_err']:.3g} "
        f"(worst tile's relative error {out['prefill_layer_max_rel_err']:.3g}); "
        f"f32 flash vs einsum {out['f32_prefill_vs_einsum']['max_abs_err']:.3g}, "
        f"decode parity {out['f32_decode_vs_forward']['max_abs_err']:.3g}; bf16 flash vs einsum "
        f"{out['bf16_prefill_vs_einsum']['max_abs_err']:.3g}; K7 on the served cache (valid {valid}) "
        f"vs plain {err_plain:.3g} (relative {rel_plain:.3g}), vs sdpa {err_sdpa:.3g}")
    log("[serve] " + json.dumps(out))
    return out


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
        from repro_torch.kernels.lap_auction import lap_auction

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
            s0, l0, t0 = auction.loop_syncs.count, lap_auction.launches, time.perf_counter()
            out = self.orig[0](benefit, *a, **k)
            self.events.append(dict(
                what="auction", shape=list(benefit.shape), wall_s=time.perf_counter() - t0,
                use_kernel=bool(k["use_kernel"] if "use_kernel" in k else a[3]),
                bid_rounds=int(out[3].max()) if len(out[3]) else 0,
                loop_syncs=auction.loop_syncs.count - s0,
                lap_auction_launches=lap_auction.launches - l0,
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
            s0, l0, t0 = auction.loop_syncs.count, lap_auction.launches, time.perf_counter()
            out = self.orig[4](cost, *a, **k)
            if cost.is_cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            iters = out[2].cpu()
            self.events.append(dict(
                what="fused_auction", shape=list(cost.shape), wall_s=wall,
                bid_rounds=int(iters.max()), bid_iters=int(iters.sum()),
                converged=bool(out[3].cpu().all()),
                use_kernel=bool(a[5]), loop_syncs=auction.loop_syncs.count - s0,
                lap_auction_launches=lap_auction.launches - l0,
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


def check_kernel_solves(events, what, kn, path):
    """Every auction solve of a path that asked for the kernel launched
    ``lap_auction`` once and read nothing back (``loop_syncs`` 0), and the
    path's node match (kn x kn, for each kn given) and 4x4 pair fan-out
    were among them."""
    solves = [e for e in events if e["what"] == what and e["use_kernel"]]
    check(solves, f"{path}: no auction solve asked for the kernel")
    for e in solves:
        check(e["lap_auction_launches"] == 1 and e["loop_syncs"] == 0,
              f"{path}: a kernel solve of {e['shape']} launched lap_auction "
              f"{e['lap_auction_launches']} times with {e['loop_syncs']} host syncs")
    shapes = {tuple(e["shape"][-2:]) for e in solves}
    need = {(k, k) for k in (kn if isinstance(kn, (list, tuple)) else [kn])} | {(4, 4)}
    check(need <= shapes,
          f"{path}: the node match or the pair fan-out did not run on lap_auction "
          f"({sorted(need - shapes)} missing from {sorted(shapes)})")
    log(f"[check] {path}: {len(solves)} auction solves, each one lap_auction launch and no host "
        f"sync; shapes {sorted(shapes)}")


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
    from repro_torch.kernels.lap_auction import lap_auction
    from repro_torch.kernels.migration_cost import migration_cost

    sched, prof = make_scheduler(cluster, backend, device)
    jobs = synthetic_active_jobs(num_jobs, seed=1, profile=prof)
    gmap = {j.job_id: j.num_gpus for j in jobs}
    rec = Recorder()
    rounds = []
    try:
        prev = None
        for i, now in enumerate((0.0, 360.0, 720.0)):
            counts = (lap_auction.launches, migration_cost.launches, auction.loop_syncs.count, rec.solves)
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
                lap_auction_launches=lap_auction.launches - counts[0],
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
    from repro_torch.kernels.lap_auction import lap_auction
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
            launches_so_far={"lap_auction": lap_auction.launches,
                             "migration_cost": migration_cost.launches},
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
    from repro_torch.kernels.lap_auction import lap_auction

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
            loop0, l0 = auction.loop_syncs.count, lap_auction.launches
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
                lap_auction_launches=lap_auction.launches - l0,
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


# --------------------------------------------------------------------------- #
# phase 6: the paper's evaluation harness on the card
# --------------------------------------------------------------------------- #
#: wall-clock fields of an arm, not decisions (``decide_p50_s`` /
#: ``decide_p99_s`` are newer than BENCH_endtoend.json)
ARM_WALL = ("wall_s",)
ARM_WALL_METRICS = ("overhead_total_s", "decide_p50_s", "decide_p99_s")
#: policies whose priorities come from a linear program (scipy's HiGHS)
LP_POLICIES = ("gavel", "gavel-ftf")


def arm_decisions(arm):
    """An evaluation arm without its wall-clock fields."""
    out = {k: v for k, v in arm.items() if k not in ARM_WALL}
    out["metrics"] = {k: v for k, v in arm["metrics"].items() if k not in ARM_WALL_METRICS}
    return out


def evaluation_phase(device, scale):
    """(g) ``BENCH_endtoend.json``'s sweep through
    ``repro_torch.benchmarks.evaluate`` on ``device``: every ``auto`` arm
    (Algorithm 3's costs on K5) must equal the record exactly, as must the
    derived speedups.  One exception, printed with its fields: an arm of a
    policy whose priorities come from an LP (Gavel) may differ where this
    host's scipy returns another optimal vertex of a degenerate LP than the
    record's did; it must then equal, in every decision field, the same arm
    run on this host's CPU (a labelled twin), and the speedups must equal
    those of the arms so expected.  The ``tesserae-t`` arms again under ``auction_kernel``
    (every auction solve one ``lap_auction`` launch, no host sync), each
    beside its ``auto`` arm; ``scale["twins"]`` of them once more on the
    CPU, where ``auction_kernel`` is the plain loop, equal in every decision
    field (they launch nothing: CPU tensors take the plain versions)."""
    import scipy

    from repro_torch.benchmarks import evaluate
    from repro_torch.kernels.lap_auction import lap_auction
    from repro_torch.kernels.migration_cost import migration_cost

    record = json.loads((ROOT / "BENCH_endtoend.json").read_text())
    cfg = record["config"]
    want = {(a["policy"], a["scenario"]): a for a in record["arms"]}
    policies = scale.get("policies", cfg["policies"])
    scenarios = scale.get("scenarios", cfg["scenarios"])
    run = dict(num_gpus=cfg["num_gpus"], num_jobs=cfg["num_jobs"], seed=cfg["seed"])
    row = dict(arms=len(policies) * len(scenarios), **run)

    k5_0, t0 = migration_cost.launches, time.perf_counter()
    doc = evaluate.run_sweep(policies, scenarios, backend=cfg["backend"], verbose=False,
                             device=device, **run)
    row["auto_s"] = time.perf_counter() - t0
    row["auto_migration_cost_launches"] = migration_cost.launches - k5_0
    row["auto_wall_s_sum"] = sum(a["wall_s"] for a in doc["arms"])
    expected, row["lp_vertex_arms"] = [], {}
    for arm in doc["arms"]:
        tag = f"{arm['policy']} x {arm['scenario']}"
        ref = want[(arm["policy"], arm["scenario"])]
        check(set(arm) == set(ref), f"(g) {tag}: keys {sorted(set(arm) ^ set(ref))} differ")
        got_d, want_d = arm_decisions(arm), arm_decisions(ref)
        diff = [key for key in got_d if got_d[key] != want_d[key]]
        if diff and arm["policy"] in LP_POLICIES:
            # the policy's LP is degenerate: another scipy may return another
            # optimal vertex, on this host's CPU as much as with the card.
            # The card's arm must then equal this host's CPU run exactly.
            twin = evaluate.run_arm(arm["policy"], arm["scenario"], backend=cfg["backend"],
                                    device="cpu", **run)
            check(arm_decisions(twin) == got_d,
                  f"(g) {tag}: differs from BENCH_endtoend.json in {diff} and from its CPU twin")
            row["lp_vertex_arms"][tag] = dict(
                fields=diff, avg_jct_s=arm["metrics"]["avg_jct_s"],
                record_avg_jct_s=ref["metrics"]["avg_jct_s"],
                makespan_s=arm["metrics"]["makespan_s"], record_makespan_s=ref["metrics"]["makespan_s"])
            log(f"[evaluate] {tag}: differs from BENCH_endtoend.json in {diff} (avg JCT "
                f"{arm['metrics']['avg_jct_s']} vs {ref['metrics']['avg_jct_s']}) with scipy "
                f"{scipy.__version__}'s LP on this host; equal in every decision field to its CPU "
                f"twin (this host's CPU, not the card)")
            expected.append(twin)
            continue
        for key in diff:
            check(False, f"(g) {tag}: {key} differs from BENCH_endtoend.json: {got_d[key]} vs "
                  f"{want_d[key]}")
        expected.append(ref)
    tess = next(p for p in policies if p.startswith("tesserae"))
    got_x = doc["speedups_vs_" + tess]
    want_x = evaluate.derive_speedups(expected, tess)
    check(got_x == want_x, f"(g) speedups {got_x} differ from the expected arms' {want_x}")
    if len(expected) == len(record["arms"]) and not row["lp_vertex_arms"]:
        check(got_x == record["speedups_vs_" + tess], "(g) speedups differ from the record's")
    log(f"[evaluate] {len(doc['arms']) - len(row['lp_vertex_arms'])} of {len(doc['arms'])} auto "
        f"arms on {device} equal BENCH_endtoend.json in metrics, faults and match_telemetry; "
        f"{len(row['lp_vertex_arms'])} LP-policy arms equal their CPU twins instead; the speedups "
        f"equal those of the expected arms ({row['auto_s']:.1f} s; K5 launched "
        f"{row['auto_migration_cost_launches']} times)")

    rec = Recorder()
    kernel_arms = {}
    la0, t0 = lap_auction.launches, time.perf_counter()
    try:
        for sc in scenarios:
            kernel_arms[sc] = evaluate.run_arm("tesserae-t", sc, backend="auction_kernel",
                                               device=device, **run)
    finally:
        rec.close()
    row["kernel_s"] = time.perf_counter() - t0
    row["kernel_lap_auction_launches"] = lap_auction.launches - la0
    row["kernel_solves"] = sum(1 for e in rec.events if e["what"] == "auction" and e["use_kernel"])
    if device.type == "cuda":
        check_kernel_solves(rec.events, "auction", sorted({
            evaluate.workloads.scenario(sc).make_cluster(run["num_gpus"]).num_nodes
            for sc in scenarios}), "(g) auction_kernel arms")
    auto = {a["scenario"]: a for a in doc["arms"] if a["policy"] == "tesserae-t"}
    row["kernel_vs_auto"] = {}
    for sc, arm in kernel_arms.items():
        m, ma = arm["metrics"], auto[sc]["metrics"]
        d = dict(avg_jct_s=m["avg_jct_s"], auto_avg_jct_s=ma["avg_jct_s"],
                 jct_rel_diff=m["avg_jct_s"] / ma["avg_jct_s"] - 1.0,
                 makespan_s=m["makespan_s"], auto_makespan_s=ma["makespan_s"],
                 makespan_rel_diff=m["makespan_s"] / ma["makespan_s"] - 1.0,
                 migrations=m["migrations"], auto_migrations=ma["migrations"],
                 bid_iters=arm["match_telemetry"]["bid_iters"], wall_s=arm["wall_s"])
        row["kernel_vs_auto"][sc] = d
        log(f"[evaluate] tesserae-t x {sc}: auction_kernel avg JCT {d['avg_jct_s']:.1f} s, makespan "
            f"{d['makespan_s']:.1f} s; auto {d['auto_avg_jct_s']:.1f} s, {d['auto_makespan_s']:.1f} s "
            f"({100 * d['jct_rel_diff']:+.3f} %, {100 * d['makespan_rel_diff']:+.3f} %); "
            f"migrations {d['migrations']} vs {d['auto_migrations']}")

    row["cpu_twins"] = {}
    for sc in scale.get("twins", ()):
        t0 = time.perf_counter()
        twin = evaluate.run_arm("tesserae-t", sc, backend="auction_kernel", device="cpu", **run)
        check(arm_decisions(twin) == arm_decisions(kernel_arms[sc]),
              f"(g) tesserae-t x {sc} under auction_kernel: the card's arm and the CPU twin differ")
        row["cpu_twins"][sc] = time.perf_counter() - t0
        log(f"[evaluate] CPU twin (not the card) of tesserae-t x {sc} under auction_kernel: equal "
            f"to the card's arm in every decision field ({row['cpu_twins'][sc]:.1f} s)")
    log("[evaluate] " + json.dumps(row))
    return row


def scalability_phase(device, scale):
    """(h) ``repro_torch.benchmarks.scalability`` on ``device``: Part 1
    (decision time against active jobs on 256 GPUs, the 2048-job row beside
    the paper's 1.6 s) under ``auto`` and ``auction_kernel``, and Part 2
    (cluster scale) under scipy and ``auction_kernel``.  Every plan is
    feasible, every kernel auction solve is one ``lap_auction`` launch with
    no host sync, and every migrate step not already solved by scipy has
    scipy's optimal cost.  The LP baselines (host code) are not run."""
    import torch

    from repro_torch.benchmarks import scalability
    from repro_torch.core.migration import plan_migration
    from repro_torch.core.profiler import ThroughputProfile

    prof = ThroughputProfile()
    rows, records = [], []
    rec = Recorder()
    t0 = time.perf_counter()
    try:
        for backend in ("auto", "auction_kernel"):
            scalability.bench_paper_figure(prof, rows, records, backend, device, lp=False,
                                           job_counts=scale["job_counts"])
        t1 = time.perf_counter()
        scalability.bench_cluster_scale(prof, rows, records, ["scipy", "auction_kernel"], device,
                                        clusters=scale["clusters"])
    finally:
        rec.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    out = dict(part1_s=t1 - t0, part2_s=time.perf_counter() - t1, records=records)
    for r in rows:
        log(f"[scalability] {r}")
    claims = {r["backend"]: r for r in records if r["bench"] == "claim"}
    for backend, r in claims.items():
        d = next(x for x in records if x["bench"] == "decision_time" and x["jobs"] == 2048
                 and x["backend"] == backend)
        log(f"[scalability] 2048 active jobs on 256 GPUs, {backend}: cold decide() "
            f"{d['total_s']:.4f} s, warm {d['warm_total_s']:.4f} s; the paper's claim < "
            f"{scalability.PAPER_CLAIM_S} s (reported, not gated)")
    if device.type == "cuda":
        check_kernel_solves(rec.events, "auction", [c[0] for c in scale["clusters"]], "(h)")
    t2 = time.perf_counter()
    checked = 0
    for prev, new_logical, gmap, kw, res in rec.migrations:
        check_feasible(res.physical_plan, gmap, f"(h) {kw['backend']} migrate step")
        if kw["backend"] == "scipy":
            continue
        ref = plan_migration(prev, new_logical, gmap, algorithm="node", backend="scipy",
                             down_nodes=kw.get("down_nodes"), speed_factor=kw.get("speed_factor"),
                             device=device)
        check(res.matching_cost == ref.matching_cost,
              f"(h) {kw['backend']} migrate step at {prev.cluster.num_gpus} GPUs: cost "
              f"{res.matching_cost} is not scipy's {ref.matching_cost}")
        checked += 1
    out.update(steps=len(rec.migrations), scipy_checked=checked, check_s=time.perf_counter() - t2)
    log(f"[check] (h): {len(rec.migrations)} migrate steps feasible, {checked} not solved by scipy "
        f"have scipy's optimal cost ({out['check_s']:.1f} s)")
    log("[scalability] " + json.dumps(out))
    return out


def build_report():
    """Phase 1's record of what was built: ``ptxas``'s registers, static
    shared memory and spills for every attention kernel instance, and the
    ``HGMMA`` instructions in the SASS of each bf16 ``flash_attention``
    instance (it must be a tensor-core kernel: none is a failure)."""
    from repro_torch.kernels import build

    ptxas = {}
    for name in ("flash_attention", "flash_decode"):
        fresh = name in build.last_built
        if not fresh:
            log(f"[build] {name}: the library was cached by an earlier run; the ptxas numbers "
                "below are that build's")
        for fn, r in build.ptxas_report(build.compiler_log(name)).items():
            ptxas[fn] = dict(r, built_this_run=fresh)
            log(f"[build] {name}: {fn}: {r.get('registers')} registers, {r.get('smem')} B static "
                f"shared memory, {r.get('spill_stores')} B spill stores, "
                f"{r.get('spill_loads')} B spill loads, {r.get('stack')} B stack")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[build] cuobjdump not found: the SASS of the bf16 flash_attention instances was NOT checked")
        return dict(ptxas=ptxas, hgmma=None)
    sass = subprocess.run([tool, "-sass", str(build._target("flash_attention"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if "flash_attention_wgmma" in fn:
                hgmma[fn] = 0
        elif fn in hgmma and "HGMMA" in line:
            hgmma[fn] += 1
    log(f"[build] HGMMA instructions per bf16 flash_attention instance: {json.dumps(hgmma)}")
    check(hgmma and all(n > 0 for n in hgmma.values()),
          f"the bf16 flash_attention instances hold no HGMMA instruction: {hgmma}")
    return dict(ptxas=ptxas, hgmma=hgmma)


def run(device, scale):
    import numpy as np
    import torch

    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.migration import plan_migration
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.lap_auction import lap_auction
    from repro_torch.kernels.lap_bid import lap_bid_batched, lap_bid_fused_batched
    from repro_torch.kernels.migration_cost import migration_cost

    counted = {
        "lap_auction": lap_auction,
        "lap_bid_batched": lap_bid_batched,
        "migration_cost": migration_cost,
        "lap_bid_fused_batched": lap_bid_fused_batched,
        "flash_attention": flash_attention,
        "flash_decode": flash_decode,
    }
    serve = scale.get("serve", SERVE_REHEARSAL)

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counted.items()}

    device = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    built = dict(ptxas={}, hgmma=None)

    # ---- phase 1: environment + build -------------------------------------- #
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {device}")
    if device.type == "cuda":
        log(f"[env] {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        build.build_all()
        log(f"[env] kernels built in {build.last_build_s:.3f} s "
            f"(load {time.perf_counter() - t0:.3f} s) into {build.BUILD_DIR}; compiled in this run: "
            f"{', '.join(build.last_built) or 'none (all cached)'}")
        built = build_report()

    # ---- phase 2: kernels vs plain at the main path's shapes --------------- #
    kn = scale["nodes"]
    lap_rows = {
        "fanout": compare_lap_bid((scale["fanout"], 4, 4), device, gen),
        "node": compare_lap_bid((1, kn, kn), device, gen),
        "ties": compare_lap_bid((4, 8, 600), device, gen, ties=True, reps=5),
    }
    auction = auction_rows(kn, scale["fanout"], device, gen)
    auction.update(wide_rows(device, gen, square=scale.get("wide_square", False)))
    mig_row = compare_migration_cost(kn * 4, device, gen)
    fused_rows = {
        "fanout": compare_lap_bid_fused((scale["fanout"], 4, 4), device, gen, tb="mixed"),
        "node": compare_lap_bid_fused((1, kn, kn), device, gen, tb="zero"),
        "ties": compare_lap_bid_fused((4, 8, 600), device, gen, ties=True, reps=5),
        "non_integer": compare_lap_bid_fused(
            (4096, 4, 4), device, gen, tb="scale", non_integer=True, reps=5
        ),
    }
    k6_rows = [compare_flash_attention(shape, device, seed=10 + i, long=i > 0)
               for i, shape in enumerate(serve["k6_shapes"])]
    k7_rows = [compare_flash_decode(shape, device, seed=20 + i)
               for i, shape in enumerate(serve["k7_shapes"])]
    routing_row = check_flash_routing(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- phase 3 (a, b): the round's path ---------------------------------- #
    cluster = ClusterSpec(kn, 4)
    zero_counts()
    t0 = time.perf_counter()
    kernel_rounds, kernel_rec = decide_three(cluster, "auction_kernel", device, scale["jobs_decide"])
    sim_rows, sim_rec = run_sim(cluster, device, scale["jobs_sim"], scale["sim_rounds"])
    launches = read_counts()
    log(f"[main path] {time.perf_counter() - t0:.3f} s; launches {json.dumps(launches)}")
    if device.type == "cuda":  # CPU tensors take the plain versions, uncounted
        check(launches["lap_auction"] > 0, "the main path never launched lap_auction")
        check(launches["migration_cost"] > 0, "the main path never launched migration_cost")
        check_kernel_solves(kernel_rec.events + sim_rec.events, "auction", kn, "(a)/(b)")

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
        check(fused_launches["lap_auction"] > 0, "the fused path never launched lap_auction")
        check_kernel_solves(replay_rec.events + fsim_rec.events, "fused_auction", kn, "(c)/(d)")

    # the rectangular packing shape a real round solved, kernel vs plain
    packing = [r for r in sim_rows if r["packing_edges"] > 0]
    check(packing, "no simulator round solved a packing LAP")
    big = max(packing, key=lambda r: r["placed"] * r["pending"])
    rect = (1, min(big["placed"], big["pending"]), max(big["placed"], big["pending"]))
    lap_rows["packing"] = compare_lap_bid(rect, device, gen, reps=10)
    pack = torch.randint(-64, 1, rect, generator=gen, dtype=torch.int32).float().to(device)
    auction["packing"], _ = compare_lap_auction("packing", pack, device, rect=True, one_cta=True)

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

    # ---- phase 5: serving llama3-8b ---------------------------------------- #
    zero_counts()
    t0 = time.perf_counter()
    serve_row = serve_phase(device, serve)
    serve_launches = read_counts()
    log(f"[serve path] {time.perf_counter() - t0:.3f} s; launches {json.dumps(serve_launches)}")
    if device.type == "cuda":  # K6 once per layer of every flash forward
        want = serve_row["flash_forwards"] * serve_row["layers"]
        check(serve_launches["flash_attention"] == want,
              f"the serving path launched flash_attention {serve_launches['flash_attention']} "
              f"times, wanted {want}")
        check(serve_launches["flash_decode"] == 1, "flash_decode was not launched on the served cache")

    # ---- phase 6: the evaluation harness ------------------------------------ #
    zero_counts()
    t0 = time.perf_counter()
    eval_row = evaluation_phase(device, scale.get("evaluate", EVAL_REHEARSAL))
    eval_launches = read_counts()
    log(f"[evaluate path] {time.perf_counter() - t0:.3f} s; launches {json.dumps(eval_launches)}")
    if device.type == "cuda":
        check(eval_row["auto_migration_cost_launches"] > 0, "(g): the auto arms never launched K5")
        check(eval_launches["lap_auction"] > 0, "(g): the auction_kernel arms never launched lap_auction")
    zero_counts()
    t0 = time.perf_counter()
    scal_row = scalability_phase(device, scale.get("scalability", SCALABILITY_REHEARSAL))
    scal_launches = read_counts()
    log(f"[scalability path] {time.perf_counter() - t0:.3f} s; launches {json.dumps(scal_launches)}")
    if device.type == "cuda":
        check(scal_launches["lap_auction"] > 0, "(h) never launched lap_auction")
        check(scal_launches["migration_cost"] > 0, "(h) never launched migration_cost")
    by_path = {name: {"round": launches[name], "fused": fused_launches[name],
                      "evaluate": eval_launches[name], "scalability": scal_launches[name]}
               for name in ("lap_auction", "migration_cost", "lap_bid_batched",
                            "lap_bid_fused_batched")}

    node = auction["node_cold"]
    kernels = [dict(
        name="lap_auction", route="cuda", source="src/repro_torch/kernels/csrc/lap_auction.cu",
        replaces="src/repro/kernels/lap_bid.py:149",
        also_replaces=["src/repro/kernels/lap_bid.py:398", "src/repro/kernels/lap_bid.py:343",
                       "src/repro/kernels/lap_bid.py:283", "src/repro/core/matching/auction.py:173"],
        launches=sum(by_path["lap_auction"].values()), launches_by_path=by_path["lap_auction"],
        max_abs_err=max(r.get("max_abs_err", 0.0) for r in auction.values()), ms=node["ms"],
        plain_ms=node["plain_ms"], bound_ms=node["bound_ms"], bound_by=node["bound_by"],
        library_ms=None, shape=node["shape"], rounds=node["rounds"],
        ms_per_round=node["ms_per_round"], plain_ms_per_round=node["plain_ms_per_round"],
        other_shapes=[{key: r.get(key) for key in (
            "case", "shape", "rounds", "ms", "ms_per_round", "plain_ms", "plain_ms_per_round",
            "bound_ms", "bound_by", "one_cta_ms", "cost", "scipy_cost", "wall_ms")}
            for k, r in auction.items() if k != "node_cold"],
    )]
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
            launches=sum(by_path[name].values()), launches_by_path=by_path[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"],
        ))
    kernels[-1]["also_replaces"] = ["src/repro/kernels/lap_bid.py:283"]
    for k in kernels:  # the bid-only kernels: the loop that called them is lap_auction now
        if k["name"].startswith("lap_bid"):
            k["main_path_route"] = "lap_auction"
    for name, rows, source, replaces in (
        ("flash_attention", k6_rows, "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:89"),
        ("flash_decode", k7_rows, "src/repro_torch/kernels/csrc/flash_decode.cu",
         "src/repro/kernels/flash_decode.py:86"),
    ):
        row = rows[0]  # the serving path's shape
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=serve_launches[name], launches_by_path={"serve": serve_launches[name]},
            max_abs_err=row["max_abs_err"], rel_err=row["rel_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"], share_of_bound=row["share_of_bound"],
            x_library=row["x_library"],
            other_shapes=[{key: r[key] for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "max_abs_err", "rel_err",
                                                   "share_of_bound", "x_library")} for r in rows[1:]],
        ))
        if device.type == "cuda":
            kernels[-1]["instances"] = {fn: r for fn, r in built["ptxas"].items() if name in fn}
            if name == "flash_attention":
                kernels[-1]["hgmma"] = built["hgmma"]
    next(k for k in kernels if k["name"] == "flash_attention")["head_dim_routing"] = routing_row
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
