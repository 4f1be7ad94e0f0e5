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
depth (``transformer.forward`` prefill, ``greedy_generate``), the MoE
and MLA families at full width (DBRX-132B, DeepSeek-V2-236B), the SSM
and hybrid families at full width and depth (Mamba2-780M, Zamba2-2.7B), the
encoder-decoder at full width and depth (SeamlessM4T-medium) and
the other dense configs (Nemotron-4-340B at full width on K6/K7 at head dim
192, Qwen3-14B and Qwen2-VL-2B at full width and depth), runs the
paper's evaluation harness (``repro_torch.benchmarks.evaluate`` and
``.scalability``), trains Llama-3-8B at full width (``make_train_step``,
``save_checkpoint``/``restore_checkpoint``, ``train_loop``), and checks what
comes out:

1. environment: the card, torch/CUDA versions, the kernels' build time;
   what ``ptxas`` gave each attention kernel instance (registers, static
   shared memory, spills; every bf16 K6 instance (head dims 64, 80, 128,
   192), the head-dim-80 instances and K7's tensor-core instances (every
   head dim) must not spill, and the flash_attention compiler log
   must hold no C7508 (``setmaxnreg`` ignored) or C7512 (wgmma
   serialised)), and the ``HGMMA`` (wgmma) and ``USETMAXREG``
   (``setmaxnreg``) instructions in the SASS of each bf16
   ``flash_attention`` instance (``cuobjdump -sass``): at least one and two;
   the ``HMMA`` (``mma.sync``) instructions of each bf16 K7 instance: at
   least one; every f32 K6 and K7 instance must not spill either, and its
   SASS must hold ``FFMA``s and no ``HMMA`` or ``HGMMA`` (exact f32
   products);
2. kernels vs their plain versions at the main path's shapes (exact,
   ``lap_bid_fused_batched`` bit for bit also on non-integer costs; the bid
   kernels also at 1x4096x4096, more than the L2 holds, and
   ``migration_cost`` also at 48x48, phase 6 (g)'s cluster, with the time
   to read its 2048x2048 result back to the host; beside ``lap_bid_batched``
   a PyTorch row max over the same matrix, the card's read rate for it;
   the bid kernels and ``migration_cost`` timed as the replay cycles
   through copies of their inputs larger than the L2 together
   (``hbm_ms``), so their time is held to an HBM bound it can be compared
   with, and also on one set of inputs as earlier runs timed them
   (``l2_ms``); first a one-element ``zero_()`` in the same CUDA-graph
   replay, printed as the launch floor beside the rows whose bound is far
   below it;
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
   shapes, at ``prefill_32k`` / ``decode_32k``'s length, at zamba2's
   head dim 80 and nemotron-4's 192 (K6 also in f32 at both and at 128 and
   64, within 2e-5; K7 in f32 on (e)'s and (e6)'s caches and over whole
   32768-slot caches at D 128 and 192 and at D 80, group 1, within 2e-5)
   and at deepseek-67b's 64 / 8 heads (K7 also over a whole 32768-slot
   cache at D 192, groups 12 and 1, at D 128, group 8, and at D 80 and 64,
   group 1, on its tensor-core instance), with
   kernel / plain / bound / library times (and, for the attention kernels,
   the share of the bound and the ratio to the library call; for K7 the
   plan's instance, splits and blocks, its blocks per SM held to the
   runtime's occupancy calculator, and the instance's ``ptxas`` registers
   and spills); a causal
   ``sdpa`` at head dim 96 (no flash instance) and at MLA's widths (q/k
   192, v 128) runs the einsum path on the card, equal to the CPU's at
   2e-5, and raises under ``REPRO_USE_FLASH=1``;
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
5. serving, one row at a time (:func:`serve_row`), bf16 on random weights
   from a seeded ``torch.Generator`` on the card, freed after the row, each
   row its own path with the counters zeroed before and read after:
   ``llama3-8b`` at full width and depth, then the MoE and MLA families at
   full width, (e2) ``dbrx-132b`` on 8 of 40 layers and (e3)
   ``deepseek-v2-236b`` on 6 of 60, then the SSM and the hybrid at full
   width and depth, (e4) ``mamba2-780m`` (no attention: no kernel may
   launch) and (e5) ``zamba2-2.7b`` (K6 at head dim 80 once per
   application of its shared block, 6 a forward; K7 on group 0's cache),
   with 64 + 64 tokens served (one ``ssm_chunk``) and their f32 checks at
   full depth (stepped decode against the forward; (e5)'s flash forward
   against the einsum forward), which print the first block where the two
   paths part if they miss 1e-4 (:func:`first_parting_block`); then (e6)
   ``seamless-m4t-medium`` at full width and depth (12 encoder and 12
   decoder layers over 512 random audio frames; K6 at D 64 in the
   decoder's causal self-attention, once a decoder layer; the encoder and
   every cross-attention on the einsum path, non-causal; its bounds from
   :func:`encdec_row_bounds`; served decoding attends to zero cross K/V,
   as the reference's ``greedy_generate`` does (ROADMAP D15), so its
   stepped logits are held to the forward on zero frames, and
   ``prefill_cross`` then ``decode_step`` to the forward on random frames,
   in f32 at 1e-4); then the
   other dense configs at full width, (e7) ``nemotron-4-340b`` on 4 of 96
   layers (K6 and K7 at head dim 192, group 12; its bf16 einsum forward at
   S 2048 and its f32 checks on 1 layer at S 2048, to fit the card),
   (e8) ``qwen3-14b`` at full depth (qk-norm, group 5; f32 checks on the
   first 19 layers, as many as fit) and (e9) ``qwen2-vl-2b`` at full depth (M-RoPE; the prefill
   carries the vision stub's 256 image positions before 7936 tokens).  (e) a prefill forward of 8192 random
   tokens (2048 for (e3)): GQA on the flash branch (sdpa's default
   on CUDA; K6 launched once per layer, 48/8 heads in (e2)), each layer's
   K6 output held to the plain version on that layer's q/k/v (3e-2; 1e-2
   relative per query tile); MLA's v head dim differs from its q/k head
   dim (F7), so (e3) runs the einsum path and launches no kernel; no
   prefill may beat its bound; a dense row also runs the einsum path's
   forward.
   (f) ``greedy_generate`` with batch 8, a 32-token prompt and 32 new
   tokens against an 8192-slot cache, and one forward of the 64 tokens;
   then, for GQA, K7 launched on layer 0's final cache with the last step's
   q (valid_len 63; group 4, 6 in (e2)) and held to its plain version
   (3e-2; 1e-2 relative per head) and to the einsum ``sdpa`` (3e-2).  The
   whole-model comparisons — flash forward vs einsum forward, stepped
   logits vs the forward's — are enforced on the same weights upcast to
   f32 (1e-4): a dense or SSM row on as many layers and prefill tokens
   as fit the card (:func:`check_cuts`; all of llama3-8b's); a MoE row on
   its first 2 layers, after the bf16 model is freed, and they see the
   routing: each
   layer's expert choices are recorded on both paths, every flip must sit
   at a near tie (margin <= 1e-4, printed), and the logits are held before
   the first token routed differently; stepped decode is held at B 1 x 8
   tokens, where ``capacity_of`` is 8 and no expert overflows, and the B 8
   x 64-token run is reported with the choices its forward dropped.  In
   bf16 the dense row's comparisons are reported with each path's distance
   from the f32 forward (at depth 32 bf16 rounding alone moves logits by up
   to ~0.08, the einsum path's as much as the flash path's).  K6 must have
   launched once per layer of every flash forward, K7 once, nothing else;
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
   before (h) and read after each;
7. training ``llama3-8b`` at full width, 4 of its 32 layers (bf16 params,
   f32 AdamW moments, remat "nothing"; B 4 x S 2048; random weights from a
   seeded ``torch.Generator`` on the card, data from ``batch_for``) through
   ``make_train_step``: (a) one step at microbatches 1 and one at 2 from the
   same state — finite loss, grad norms within 1e-2, every leaf a nonzero
   gradient (each layer's wq/wk/wv: attention under autograd takes the
   einsum path, ROADMAP D8), every parameter moved, ``REPRO_USE_FLASH=1``
   raising under grad; (b) 1 warm and 5 timed steps: step ms, tokens/s,
   ``train_mfu`` (6·N·T over the step and 989 TFLOP/s), peak memory, and a
   profiler window over one step (busy share, kernels by name and kind);
   (c) the migration path: ``save_checkpoint`` into a temporary directory
   (removed afterwards), ``restore_checkpoint`` into a fresh state (bitwise
   equal), the first step after it (loss within 1e-6 of the uninterrupted
   run's), bytes, seconds and GB/s beside the simulator's
   ``MIGRATION_OVERHEAD_S``; (d) ``train_loop`` on the reduced config in f32
   twice on the card and twice on the host's CPU on one thread (losses
   within 1e-5, params within 1e-5 relative L2; whether each side repeats
   itself bit for bit is printed, and how far a run on the host's thread
   pool lands from the one-thread run).  Each op of the card's two runs,
   forward and backward, is logged with a checksum of its output
   (:func:`op_recorder`), and the first op that differs between them is
   printed with its inputs' shapes, strides and addresses mod 256 (the
   initial state ``train_loop`` draws on the host is recorded too).
   Counters zeroed before and read after: the training path launches no
   kernel;
8. the dry-run (``repro_torch.launch.dryrun``), which needs no card: (a) its
   command line in five subprocesses on the host that see no card: every
   arch at ``prefill_32k`` and every arch at ``decode_32k`` on the 16x16
   mesh, mamba2 and zamba2 at ``train_4k``, and mamba2 at ``decode_32k``
   on the 2x16x16 mesh, each exiting 0 with a well-formed report per
   combination (chips, mesh, FLOPs per device > 0, no collective term);
   (b) meanwhile, row (e)'s prefill (B 1 x S 8192) and decode step (B 8,
   8192 slots) counted on abstract tensors on the 1x1 mesh and run on the
   card on the row's weights on the einsum path (``REPRO_USE_FLASH=0``)
   under ``FlopCounterMode``: the FLOPs equal exactly, the dry-run's state
   bytes those of the params (and cache) on the card; the counted FLOPs
   printed beside ``dense_row_bounds``' ``prefill_ops``, the compute and
   memory terms beside row (e)'s measured prefill and step (no gate on
   those ratios).  Counters zeroed before and read after: nothing
   launches.

Any failure exits non-zero.  The last three lines are the kernels JSON,
the card's ``name, power.limit`` and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's data-sheet peaks, kept once, in the port's roofline module
from repro_torch.roofline import HBM_BW as PEAK_BYTES_PER_S  # noqa: E402
from repro_torch.roofline import PEAK_F32_FLOPS as PEAK_F32_OPS_PER_S  # noqa: E402
from repro_torch.roofline import PEAK_F64_FLOPS as PEAK_F64_OPS_PER_S  # noqa: E402
from repro_torch.roofline import PEAK_FLOPS as PEAK_BF16_OPS_PER_S  # noqa: E402

FULL = dict(
    nodes=512, jobs_decide=512, jobs_sim=2048, sim_rounds=6, fanout=262144,
    fused_rounds=6, fused_shards=8,
    # phase 2: K1/K3 on one wide square, 67 MB of f32 (more than the L2)
    bid_wide=4096,
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
        # valid) for flash_decode; the first of each is the path's shape, then
        # decode_32k's length, dbrx's 48/8 heads (e2), zamba2's shared block
        # (D 80, row (e5)), nemotron-4's 96/8 heads at D 192 (e7) and
        # deepseek-67b's 64/8 heads (group 8, a K7 warp holds 2 heads; its
        # path has no whole-model row), seamless-m4t-medium's 16 heads at
        # D 64 (the encoder-decoder's decoder prefill, row (e6)); K6 in f32
        # at D 80, 192, 128 (row (e)'s heads) and 64 (row (e6)'s) too; K7
        # at D 192 over a whole 32768-slot cache at group 12 and, on the
        # same bytes, at group 1: a twelfth of the scoring, so its time
        # says whether the 2-stage ring hides the copies; K7 on (e6)'s
        # served cache (D 64, group 1); the whole cache at D 128 and
        # deepseek-67b's group 8; whole caches at group 1 at (e5)'s D 80
        # and (e6)'s D 64; K7 in f32 on row (e)'s served cache, over a
        # whole 32768-slot cache at D 128 and at D 192, group 12, on (e6)'s
        # served cache (D 64, group 1) and over a whole cache at group 1 and
        # D 80 (5.37 GB of f32 K and V)
        k6_shapes=[(1, 8192, 32, 8, 128), (1, 32768, 32, 8, 128), (1, 8192, 48, 8, 128),
                   (1, 8192, 32, 32, 80), (1, 8192, 96, 8, 192), (1, 8192, 64, 8, 128),
                   (1, 8192, 16, 16, 64)],
        k6_f32_shapes=[(1, 8192, 32, 32, 80), (1, 8192, 96, 8, 192), (1, 8192, 32, 8, 128),
                       (1, 8192, 16, 16, 64)],
        k7_f32_shapes=[(8, 8192, 32, 8, 128, 63), (8, 32768, 32, 8, 128, 32768),
                       (8, 32768, 96, 8, 192, 32768), (8, 8192, 16, 16, 64, 63),
                       (8, 32768, 32, 32, 80, 32768)],
        k7_shapes=[(8, 8192, 32, 8, 128, 63), (32, 32768, 32, 8, 128, 32768),
                   (8, 8192, 48, 8, 128, 63), (8, 8192, 32, 32, 80, 63),
                   (8, 8192, 96, 8, 192, 63), (8, 8192, 64, 8, 128, 63),
                   (8, 32768, 96, 8, 192, 32768), (8, 32768, 8, 8, 192, 32768),
                   (8, 8192, 16, 16, 64, 63), (8, 32768, 64, 8, 128, 32768),
                   (8, 32768, 32, 32, 80, 32768), (8, 32768, 16, 16, 64, 32768)],
    ),
    # phase 5, rows (e2) and (e3): dbrx-132b (8 of 40 layers, 54.6 GB of bf16
    # weights) and deepseek-v2-236b (6 of 60 layers, 50.7 GB) at full width.
    # MLA's prefill runs the einsum path (F7), whose f32 logits for 128 heads
    # are 2.1 GB at S 2048
    serve_moe=[
        dict(arch="dbrx-132b", reduced=False, layers=8, prefill_s=8192, batch=8, prompt=32,
             gen=32, context=8192),
        dict(arch="deepseek-v2-236b", reduced=False, layers=6, prefill_s=2048, batch=8,
             prompt=32, gen=32, context=8192),
    ],
    # phase 5, rows (e4) and (e5): mamba2-780m (1.56 GB of bf16 weights) and
    # zamba2-2.7b (4.8 GB) at full width and depth; prompt + gen is one
    # ssm_chunk (128), so the forward over the generated tokens is legal
    serve_ssm=[
        dict(arch="mamba2-780m", reduced=False, prefill_s=8192, batch=8, prompt=64, gen=64,
             context=8192),
        dict(arch="zamba2-2.7b", reduced=False, prefill_s=8192, batch=8, prompt=64, gen=64,
             context=8192),
    ],
    # phase 5, row (e6): seamless-m4t-medium (1.75 GB of bf16 weights) at
    # full width and depth, 12 encoder and 12 decoder layers; the prefill's
    # 8192 decoder tokens attend to the encoder's 512 frames
    serve_encdec=[
        dict(arch="seamless-m4t-medium", reduced=False, prefill_s=8192, batch=8, prompt=32, gen=32,
             context=8192),
    ],
    # phase 5, rows (e7)-(e9): the dense configs not run before.
    # nemotron-4-340b (4 of 96 layers, 46.5 GB of bf16 weights) at head dim
    # 192, qwen3-14b (29.5 GB, full depth; qk-norm, group 5) and
    # qwen2-vl-2b (3.55 GB, full depth; M-RoPE), which prefills 256 image
    # positions of the vision stub before its tokens.  :func:`check_cuts`
    # fits their einsum and f32 checks to the card: nemotron's einsum
    # forward at S 8192 would build a 25.8 GB f32 score tensor and as much
    # again of probabilities, so it checks S 2048 on 1 layer (51.6 GB in
    # f32 with the embedding and head); qwen3 at full depth would be 59 GB
    # in f32
    serve_dense=[
        dict(arch="nemotron-4-340b", reduced=False, layers=4, prefill_s=8192, batch=8, prompt=32,
             gen=32, context=8192),
        dict(arch="qwen3-14b", reduced=False, prefill_s=8192, batch=8, prompt=32, gen=32,
             context=8192),
        dict(arch="qwen2-vl-2b", reduced=False, prefill_s=8192 - 256, batch=8, prompt=32, gen=32,
             context=8192),
    ],
    # phase 6: BENCH_endtoend.json's whole sweep, and the scalability
    # benchmark's Part 1 (256 GPUs) and Part 2 (up to 2048 GPUs)
    wide_square=True,
    evaluate=dict(twins=("poisson-steady", "philly-failures")),
    scalability=dict(job_counts=[128, 512, 1024, 2048], clusters=[(64, 4), (256, 4), (512, 4)]),
    # phase 7: training llama3-8b at full width, 4 of its 32 layers (bf16
    # params, f32 moments: 12 bytes a parameter with the grads, ~96 GB at
    # full depth), B 4 x S 2048; then 3 f32 steps of train_loop on the
    # reduced config, card against host
    train=dict(arch="llama3-8b", reduced=False, layers=4, batch=4, seq=2048, timed_steps=5,
               f32=dict(steps=3, batch=2, seq=64)),
    # phase 8: the dry-run's command line on the host, one process each
    # (a process spends ~15 s importing and warming up there): every arch
    # at prefill_32k, every arch at decode_32k on the single-pod mesh,
    # mamba2's and zamba2's train_4k (a few seconds each), the multi-pod
    # case; while row (e)'s prefill and step are counted and run on the card
    dryrun=dict(
        cases=[("all", "prefill_32k"), ("all", "decode_32k"), ("mamba2-780m", "train_4k"),
               ("zamba2-2.7b", "train_4k"), ("mamba2-780m", "decode_32k", True)],
        workers=5,
        row=dict(arch="llama3-8b", reduced=False, prefill_s=8192, batch=8, context=8192),
    ),
)

#: the CPU rehearsal's phase 6: four arms of the record, a 64-GPU Part 2
EVAL_REHEARSAL = dict(policies=("tesserae-t", "tiresias"),
                      scenarios=("poisson-steady", "philly-failures"), twins=("philly-failures",))
SCALABILITY_REHEARSAL = dict(job_counts=[128], clusters=[(16, 4)])

#: the CPU rehearsal's serve scale (reduced llama3-8b, S = 64)
SERVE_REHEARSAL = dict(
    arch="llama3-8b", reduced=True, prefill_s=64, batch=2, prompt=8, gen=8, context=64,
    k6_shapes=[(1, 64, 4, 2, 64), (1, 64, 4, 4, 80), (1, 64, 12, 1, 192)],
    k6_f32_shapes=[(1, 64, 4, 4, 80), (1, 64, 12, 1, 192), (1, 64, 4, 2, 128), (1, 64, 2, 2, 64)],
    k7_f32_shapes=[(2, 64, 4, 2, 128, 15), (2, 64, 12, 1, 192, 64), (2, 64, 2, 2, 64, 15),
                   (2, 64, 4, 4, 80, 64)],
    k7_shapes=[(2, 64, 4, 2, 64, 15), (2, 64, 4, 4, 80, 15), (2, 64, 12, 1, 192, 15)],
)


#: the CPU rehearsal's rows (e2) and (e3): the reduced dbrx and deepseek-v2
SERVE_MOE_REHEARSAL = [
    dict(arch=arch, reduced=True, prefill_s=64, batch=2, prompt=8, gen=8, context=64)
    for arch in ("dbrx-132b", "deepseek-v2-236b")
]

#: the CPU rehearsal's rows (e4) and (e5): the reduced mamba2 and zamba2
#: (one 32-token ssm_chunk of prompt + gen)
SERVE_SSM_REHEARSAL = [
    dict(arch=arch, reduced=True, prefill_s=64, batch=2, prompt=16, gen=16, context=64)
    for arch in ("mamba2-780m", "zamba2-2.7b")
]


#: the CPU rehearsal's row (e6): the reduced seamless-m4t (2 + 2 layers,
#: d 256, 32 frames)
SERVE_ENCDEC_REHEARSAL = [
    dict(arch="seamless-m4t-medium", reduced=True, prefill_s=64, batch=2, prompt=8, gen=8, context=64),
]


def serve_dense_rehearsal():
    """The CPU rehearsal's rows (e7)-(e9): the reduced nemotron widened to
    its full head dim 192 (its reduced config keeps 64; widened, the
    rehearsal reaches the D 192 code), the reduced qwen3 and qwen2-vl (16
    image positions)."""
    from repro_torch.configs import get_reduced

    nemotron = dataclasses.replace(get_reduced("nemotron-4-340b"), head_dim=192)
    return [
        dict(arch="nemotron-4-340b", config=nemotron, prefill_s=64, batch=2, prompt=8, gen=8,
             context=64),
        dict(arch="qwen3-14b", reduced=True, prefill_s=64, batch=2, prompt=8, gen=8, context=64),
        dict(arch="qwen2-vl-2b", reduced=True, prefill_s=48, batch=2, prompt=8, gen=8, context=64),
    ]


#: the CPU rehearsal's phase 8: two command lines of the full mamba2 (its
#: decode step counts in a second), row (b) on the reduced llama3-8b
DRYRUN_REHEARSAL = dict(cases=[("mamba2-780m", "decode_32k"), ("mamba2-780m", "decode_32k", True)],
                        workers=2, row=dict(arch="llama3-8b", reduced=True, prefill_s=64, batch=2,
                                            context=64))

#: the CPU rehearsal's phase 7 (reduced llama3-8b)
TRAIN_REHEARSAL = dict(arch="llama3-8b", reduced=True, layers=None, batch=2, seq=64, timed_steps=2,
                       f32=dict(steps=3, batch=2, seq=32))


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


#: the most input copies :func:`hbm_ms` cycles through
HBM_MAX_SETS = 64


def hbm_ms(fn, args, nbytes, device, reps=20):
    """Device ms per call of ``fn(*args)`` with its operands read from HBM,
    not the L2: the :func:`graph_ms` replay cycles through ``sets`` copies
    of ``args`` and keeps every call's output, so the ``nbytes`` each call
    moves add up to twice the L2 in one replay (at most
    :data:`HBM_MAX_SETS` copies).  Returns ``(ms, sets, from_hbm)``;
    ``from_hbm`` is false where even that fits in the L2 (the smallest
    shapes, whose time is the launch's)."""
    import itertools

    import torch

    if device.type != "cuda":  # CPU rehearsal only; never reported
        return graph_ms(lambda: fn(*args), device, reps), 1, False
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    sets = max(1, min(HBM_MAX_SETS, -(-2 * l2 // nbytes)))
    copies = [tuple(args)] + [tuple(t.clone() for t in args) for _ in range(sets - 1)]
    turn, kept = itertools.count(), []
    ms = graph_ms(lambda: kept.append(fn(*copies[next(turn) % sets])), device, max(reps, sets))
    return ms, sets, sets * nbytes > l2


def share_of_bound(bound, timing):
    """``bound / ms`` for an :func:`hbm_ms` timing that streamed from HBM,
    else None: a time taken from the L2 is not held to an HBM bound."""
    ms, _, from_hbm = timing
    return bound / ms if from_hbm else None


def bound_ms(nbytes, ops, ops_rate):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_floor_ms(device, reps=20):
    """Device ms of a one-element ``zero_()`` in the same CUDA-graph replay
    as the kernels: what any launch costs, a yardstick for the rows whose
    bound is far below it (printed, never a kernel's number)."""
    import torch

    one = torch.zeros(1, device=device)
    ms = graph_ms(lambda: one.zero_(), device, reps)
    log(f"[kernel] launch floor (one-element zero_(), CUDA-graph replay): {ms:.6f} ms")
    return ms


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
    timing = hbm_ms(lap_bid_batched, (a, p), nbytes, device, reps)
    row = dict(
        shape=list(shape),
        max_abs_err=err,
        ms=timing[0],
        hbm_sets=timing[1],
        share_of_bound=share_of_bound(bnd, timing),
        # one set of inputs replayed, L2-resident where it fits (how the
        # kernel was timed before ``hbm_ms``)
        l2_ms=graph_ms(lambda: lap_bid_batched(a, p), device, reps),
        plain_ms=hbm_ms(lap_bid_top2_plain, (a, p), nbytes, device, reps)[0],
        library_ms=hbm_ms(lambda x, q: torch.topk(x - q[:, None, :], 2, dim=-1), (a, p), nbytes,
                          device, reps)[0],
        # one read of the same matrix by PyTorch's row reduction: the read
        # rate the card gives this layout (a yardstick, not the function)
        row_max_ms=hbm_ms(lambda x: torch.amax(x, dim=-1), (a,), 4 * b * n * m, device, reps)[0],
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
    timing = hbm_ms(lap_bid_fused_batched, (cost, p, tbv), nbytes, device, reps)
    row = dict(
        shape=list(shape),
        max_abs_err=err,
        ms=timing[0],
        hbm_sets=timing[1],
        share_of_bound=share_of_bound(bnd, timing),
        l2_ms=graph_ms(lambda: lap_bid_fused_batched(cost, p, tbv), device, reps),
        plain_ms=hbm_ms(lap_bid_fused_top2_plain, (cost, p, tbv), nbytes, device, reps)[0],
        library_ms=hbm_ms(lambda x: torch.topk(x, 2, dim=-1), (vals,), nbytes, device, reps)[0],
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
    """P2 and F7: unset ``REPRO_USE_FLASH``, a causal ``sdpa`` at a head dim
    the flash kernel has no instance for (96) runs the einsum path on the
    card and matches the CPU's einsum path (2e-5, f32); ``REPRO_USE_FLASH=1``
    asks for the kernel there and raises.  MLA's widths, q/k at 192 (which
    has an instance) and v at 128, launch nothing either, and ``=1`` raises
    there on the k/v shapes, as the reference's flash branch fails."""
    import torch

    import repro_torch.kernels.flash_attention as fa
    from repro_torch.models.attention import sdpa

    d = 96  # no configuration's head dim, and no instance
    cases = {"no_instance": (d, d), "mla": (192, 128)}  # (q/k head dim, v head dim)
    raise_msg = {"no_instance": f"head dim {d}", "mla": "k/v shapes differ"}
    saved = os.environ.pop("REPRO_USE_FLASH", None)
    rows = {}
    try:
        for name, (dq, dv) in cases.items():
            gen = torch.Generator().manual_seed(5)
            q, k = (torch.randn((1, 512, h, dq), generator=gen) for h in (8, 2))
            v = torch.randn((1, 512, 2, dv), generator=gen)
            os.environ.pop("REPRO_USE_FLASH", None)
            want = sdpa(q, k, v, causal=True)
            before = fa.flash_attention.launches
            got = sdpa(q.to(device), k.to(device), v.to(device), causal=True).cpu()
            check(fa.flash_attention.launches == before,
                  f"sdpa at head dims {dq}/{dv} launched the flash kernel")
            err = float((got - want).abs().max())
            check(bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5)),
                  f"sdpa at head dims {dq}/{dv} on {device} differs from the CPU's einsum path ({err})")
            raised = None
            if device.type == "cuda":
                os.environ["REPRO_USE_FLASH"] = "1"
                try:
                    sdpa(q.to(device), k.to(device), v.to(device), causal=True)
                except ValueError as exc:
                    raised = str(exc)
                check(raised is not None and raise_msg[name] in raised,
                      f"REPRO_USE_FLASH=1 at head dims {dq}/{dv} did not raise ({raised})")
                check(fa.flash_attention.launches == before, f"head dims {dq}/{dv}: a forced call launched")
            rows[name] = dict(qk_head_dim=dq, v_head_dim=dv, shape=[1, 512, 8, 2, dq],
                              max_abs_err=err, forced_raises=raised)
            log(f"[check] sdpa at head dims {dq}/{dv}, env unset: the einsum path on {device}, max err "
                f"{err:.3g} vs the CPU's; REPRO_USE_FLASH=1 raises: {raised}")
    finally:
        os.environ.pop("REPRO_USE_FLASH", None)
        if saved is not None:
            os.environ["REPRO_USE_FLASH"] = saved
    return rows


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
    timing = hbm_ms(migration_cost, args, nbytes, device, reps)
    row = dict(
        shape=[u, u, 2],
        max_abs_err=float((got - want).abs().max()),
        ms=timing[0],
        hbm_sets=timing[1],
        share_of_bound=share_of_bound(bnd, timing),
        l2_ms=graph_ms(lambda: migration_cost(*args), device, reps),
        plain_ms=hbm_ms(migration_cost_plain, args, nbytes, device, reps)[0],
        library_ms=None,
        bound_ms=bnd,
        bound_by=by,
        eager_ms=timed(lambda: migration_cost(*args), device, reps),
        readback_ms=timed(lambda: got.cpu(), device, 5, 1),
    )
    log(f"[kernel] migration_cost {u}x{u}: bit-identical to plain; kernel {row['ms']:.6f} ms, "
        f"then {row['readback_ms']:.6f} ms to read the {8 * u * u} bytes back to the host; "
        + json.dumps(row))
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


#: the attention kernels' absolute gate against the plain version, by dtype
#: (f32 runs on CUDA cores, whose sums differ from the plain version's in
#: order only)
ATTN_TOL = {"bfloat16": 3e-2, "float32": 2e-5}


def compare_flash_attention(shape, device, seed, long=False, dtype="bfloat16"):
    """``flash_attention`` (K6) against its plain version on random q
    (B, S, H, D) and k/v (B, S, KV, D) of ``dtype``, causal, at
    ``ATTN_TOL`` and, per 128-query tile, within ``REL_TOL`` relative L2
    error.  The bound counts bf16 work at the tensor cores' peak and f32
    work at the CUDA cores' (the f32 instance's)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    b, s, h, kv, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    tdtype, tol = getattr(torch, dtype), ATTN_TOL[dtype]

    def rand(*sh):
        return torch.randn(sh, generator=gen, device=device).to(tdtype)

    q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    err, ok = logits_close(got.reshape(b, s, -1), want.reshape(b, s, -1), tol)
    check(ok, f"flash_attention {shape} {dtype}: differs from plain beyond {tol} (max {err})")
    rel = rel_err(got, want, 128)
    check(rel <= REL_TOL, f"flash_attention {shape} {dtype}: a query tile's relative error {rel} > "
          f"{REL_TOL}")

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True,
        )

    lib_err = None
    if not long:  # the yardstick computes the same function
        lib_err, lib_ok = logits_close(library().transpose(1, 2).reshape(b, s, -1),
                                       want.reshape(b, s, -1), 3e-2)
        check(lib_ok, f"flash_attention {shape} {dtype}: scaled_dot_product_attention disagrees "
              f"({lib_err})")
    del got, want
    g = dict(reps=2, replays=1, warmup=1) if long else dict(reps=5, replays=2, warmup=2)
    nbytes = q.element_size() * (2 * b * s * h * d + 2 * b * s * kv * d)  # q, out; k, v
    ops = 4 * b * h * s * s * d // 2  # causal: half of the S x S products
    bnd, by = bound_ms(nbytes, ops, PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_F32_OPS_PER_S)
    row = dict(
        shape=list(shape), dtype=dtype, causal=True, max_abs_err=err, rel_err=rel,
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
    log(f"[kernel] flash_attention {shape} {dtype}: within {tol} of plain, worst tile's relative "
        f"error {rel:.3g} (limit {REL_TOL}); " + json.dumps(row))
    return row


def k7_symbol(plan, d):
    """The part of the mangled name of the partial kernel a K7 ``plan`` at
    head dim ``d`` launches, as ``ptxas`` reports it."""
    if plan["instance"] == "mma_bf16":
        return f"flash_decode_partial_mmaILi{d}E"
    return f"flash_decode_partial_ffmaILi{d}ELi{plan['heads_per_warp']}EE"


def compare_flash_decode(shape, device, seed, ptxas=None, dtype="bfloat16"):
    """``flash_decode`` (K7) against its plain version on a random cache
    (B, S, KV, D) of ``dtype``, ``valid_len`` slots valid, at ``ATTN_TOL``
    and, per head, within ``REL_TOL`` relative L2 error; on the card the
    plan's blocks per SM held to the occupancy calculator's, and
    (``ptxas``: phase 1's report) the instance's registers and spills
    beside the row.  The bound counts bytes of ``dtype`` and bf16 work at
    the tensor cores' peak, f32 work at the CUDA cores'."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain

    b, s, h, kv, d, valid = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    tdtype, tol = getattr(torch, dtype), ATTN_TOL[dtype]

    def rand(*sh):
        return torch.randn(sh, generator=gen, device=device).to(tdtype)

    q, k, v = rand(b, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    plan = fd.launch_plan(q.shape, k.shape, q.dtype)
    got = flash_decode(q, k, v, valid)
    want = flash_decode_plain(q, k, v, valid)
    err, ok = logits_close(got, want, tol)
    check(ok, f"flash_decode {shape} {dtype}: differs from plain beyond {tol} (max {err})")
    rel = rel_err(got, want)
    check(rel <= REL_TOL, f"flash_decode {shape} {dtype}: a head's relative error {rel} > {REL_TOL}")
    mask = (torch.arange(s, device=device) < valid)[None, None, None, :]

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )

    lib_err, lib_ok = logits_close(library()[:, :, 0], want, 3e-2)
    check(lib_ok, f"flash_decode {shape} {dtype}: scaled_dot_product_attention disagrees ({lib_err})")
    # valid K, V slots; q, out
    nbytes = q.element_size() * (2 * b * valid * kv * d + 2 * b * h * d)
    ops = 4 * b * h * valid * d
    bnd, by = bound_ms(nbytes, ops, PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_F32_OPS_PER_S)
    g = dict(reps=10, replays=3)
    row = dict(
        shape=list(shape), dtype=dtype, max_abs_err=err, rel_err=rel, library_err=lib_err,
        **{key: plan[key] for key in ("instance", "tile", "chunks", "splits", "tiles_per_split",
                                       "blocks", "blocks_per_sm")},
        ms=graph_ms(lambda: flash_decode(q, k, v, valid), device, **g),
        eager_ms=timed(lambda: flash_decode(q, k, v, valid), device, 10, 2),
        plain_ms=timed(lambda: flash_decode_plain(q, k, v, valid), device, 3, 1),
        library_ms=graph_ms(library, device, **g),
        library_note="scaled_dot_product_attention(boolean mask, enable_gqa=True)",
        bound_ms=bnd, bound_by=by, ops=ops, bytes=nbytes,
    )
    row["gb_per_s"] = nbytes / row["ms"] / 1e6
    row.update(share_of_bound=bnd / row["ms"], x_library=row["ms"] / row["library_ms"])
    if device.type == "cuda":
        row["card_blocks_per_sm"] = fd.card_blocks_per_sm(plan, d)
        check(row["card_blocks_per_sm"] == plan["blocks_per_sm"],
              f"flash_decode {shape} {dtype}: the plan counts {plan['blocks_per_sm']} blocks an SM, "
              f"the card's occupancy calculator {row['card_blocks_per_sm']}")
        sym = k7_symbol(plan, d)
        row["ptxas"] = {fn: r for fn, r in (ptxas or {}).items() if sym in fn}
    log(f"[kernel] flash_decode {shape} {dtype}: within {tol} of plain, worst head's relative error "
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
    """``tree`` (nested dicts and lists of tensors) upcast to f32 in place:
    each leaf is replaced by its f32 copy, which frees the bf16 leaf, so the
    peak is the f32 tree and one bf16 leaf, not both trees."""
    for key, leaf in list(tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(leaf, (dict, list)):
            _upcast(leaf)
        else:
            tree[key] = leaf.float()
    return tree


# --------------------------------------------------------------------------- #
# phase 5, rows (e2) and (e3): serving the MoE and MLA families
# --------------------------------------------------------------------------- #
#: a routing flip between two f32 paths is allowed only where the token's
#: k-th and (k+1)-th router probabilities are this close in either path
NEAR_TIE = 1e-4


class RouteRecorder:
    """Records every ``moe_route`` call (the MoE layers in order) while it
    is entered: each call's f32 probabilities, experts and keep mask."""

    def __enter__(self):
        import repro_torch.models.mlp as mlp

        self.mlp, self.real, self.calls = mlp, mlp.moe_route, []

        def recording(cfg, probs, groups):
            r = self.real(cfg, probs, groups)
            self.calls.append(dict(probs=probs, experts=r["experts"],
                                   keep=r["keep"].reshape(r["experts"].shape)))
            return r

        mlp.moe_route = recording
        return self

    def __exit__(self, *exc):
        self.mlp.moe_route = self.real

    def dropped(self):
        return sum(int((~c["keep"]).sum()) for c in self.calls)


def _gaps(probs, k):
    """Per token, the gaps between its adjacent top-(k+1) probabilities:
    (T, k), column j the gap from rank j to rank j+1."""
    top = probs.float().topk(k + 1, dim=-1).values
    return top[:, :-1] - top[:, 1:]


def routing_diff(want, got, k):
    """Layer by layer (lists of recorded routes over the same tokens, in
    order), where two paths route differently.  A token's choices are its
    top-k experts in rank order.  Where they differ, they must differ at
    near ties: at the first rank that differs and, if the set of experts
    differs, at the k-th rank too, the gap to the next probability is <=
    ``NEAR_TIE`` in either path.  A change of the set is a flip: it moves
    the capacity slots of every later token, so every token from the first
    flip on is cut from the later layers.  A change of order alone (a
    reorder) moves no slot — a choice's slot counts the earlier tokens'
    choices of its expert — and cuts nothing.  A token whose keep differs
    with the same experts must follow a flip of the same layer.  Returns
    the counts, the flips and reorders with their margins and both paths'
    experts, and ``cut``, the first token any layer flipped or kept
    differently."""
    import torch

    cut, flips, reorders, downstream, bad = None, [], [], 0, []
    for layer, (w, g) in enumerate(zip(want, got)):
        w_set, w_order = w["experts"].sort(-1)
        g_set, g_order = g["experts"].sort(-1)
        set_diff = (w_set != g_set).any(-1)
        keep_diff = (w["keep"].gather(-1, w_order) != g["keep"].gather(-1, g_order)).any(-1)
        rank_diff = w["experts"] != g["experts"]
        moved = torch.nonzero(rank_diff.any(-1) | keep_diff).flatten().tolist()
        if not moved:
            continue
        gw, gg = _gaps(w["probs"], k), _gaps(g["probs"], k)
        first_flip = None
        for t in moved:
            if cut is not None and t >= cut:
                downstream += 1
                continue
            if bool(rank_diff[t].any()):
                j = int(rank_diff[t].nonzero()[0])
                ranks = [j, k - 1] if bool(set_diff[t]) else [j]
                m = min(max(float(gw[t, r]) for r in ranks), max(float(gg[t, r]) for r in ranks))
                entry = dict(layer=layer, token=t, rank=j, margin=m,
                             experts_want=w["experts"][t].tolist(),
                             experts_got=g["experts"][t].tolist())
                if bool(set_diff[t]):
                    first_flip = t if first_flip is None else first_flip
                    flips.append(entry)
                else:
                    reorders.append(entry)
                if m > NEAR_TIE:
                    bad.append(entry)
            elif first_flip is None or t < first_flip:
                bad.append(dict(layer=layer, token=t, keep_moved_without_a_flip=True))
        div = torch.nonzero(set_diff | keep_diff).flatten().tolist()
        if div:
            cut = div[0] if cut is None else min(cut, div[0])
    return dict(flips=len(flips), reorders=len(reorders), downstream=downstream, cut=cut,
                flip_list=flips[:10], reorder_list=reorders[:10], not_near_ties=bad[:10])


def moe_row_bounds(cfg, s, batch, cache_len):
    """The least time a prefill of B 1 x ``s`` tokens and a decode step at
    ``batch`` could take on the card: the larger of the operations at the
    bf16 peak (the weight GEMMs, every expert's capacity slots, the causal
    attention core, the head) and the weights read once; a decode step
    reads every weight and the cache's valid half at most (bytes)."""
    from repro_torch.models.mlp import capacity_of

    d, h, e = cfg.d_model, cfg.num_heads, cfg.num_experts
    if cfg.use_mla:
        r, qn, qr, vd = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        proj = d * h * (qn + qr) + d * (r + qr) + r * h * (qn + vd) + h * vd * d
        core, cache_row = s * s * h * (qn + qr + vd), r + qr
    else:
        hd, kv = cfg.head_dim, cfg.num_kv_heads
        proj = 2 * d * h * hd + 2 * d * kv * hd
        core, cache_row = s * s * h * 2 * hd, 2 * kv * hd
    experts = 2 * e * capacity_of(cfg, s) * 3 * d * cfg.moe_d_ff
    shared = 2 * s * 3 * d * cfg.moe_d_ff * cfg.num_shared_experts
    ops = (cfg.num_layers * (2 * s * proj + core + experts + shared + 2 * s * d * e)
           + 2 * s * d * cfg.vocab_size)
    weights = 2 * cfg.param_count()
    prefill = bound_ms(weights, ops, PEAK_BF16_OPS_PER_S)
    cache = cfg.num_layers * batch * cache_len * cache_row  # bf16, half the slots valid
    return dict(prefill_bound_ms=prefill[0], prefill_bound_by=prefill[1], prefill_ops=ops,
                step_bound_ms=(weights + cache) / PEAK_BYTES_PER_S * 1e3, weight_bytes=weights)


def dense_row_bounds(cfg, s, batch, valid):
    """The least time a prefill of B 1 x ``s`` positions and a decode step
    at ``batch`` of a dense GQA row could take on the card: the prefill's
    operations (the weight GEMMs, the causal attention core at half of
    S x S, the head) at the bf16 peak, its bytes the weights read once; a
    decode step reads every weight but the embedding table (a few rows of
    it) and the ``valid`` slots of every layer's K and V cache (bytes)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_token = 2 * (2 * d * h * hd + 2 * d * kv * hd) + 2 * cfg._ffn_params(cfg.d_ff)
    ops = cfg.num_layers * (s * per_token + 4 * h * s * s // 2 * hd) + 2 * s * d * cfg.vocab_size
    weights = 2 * cfg.param_count()
    prefill = bound_ms(weights, ops, PEAK_BF16_OPS_PER_S)
    step_bytes = weights - (0 if cfg.tie_embeddings else 2 * cfg.vocab_size * d)
    step_bytes += cfg.num_layers * batch * valid * 2 * kv * hd * 2
    return dict(prefill_bound_ms=prefill[0], prefill_bound_by=prefill[1], prefill_ops=ops,
                step_bound_ms=step_bytes / PEAK_BYTES_PER_S * 1e3, step_bytes=step_bytes,
                weight_bytes=weights)


def encdec_row_bounds(cfg, s, batch, valid):
    """The least time a prefill of B 1 x ``s`` decoder tokens over the
    ``frontend_len`` encoder frames and a decode step at ``batch`` of the
    encoder-decoder could take on the card.  The prefill's operations at
    the bf16 peak: the encoder's (the weight GEMMs over the frames, the
    bidirectional attention core at F x F), each decoder layer's
    self-attention (its GEMMs, the causal core at half of S x S), its
    cross-attention (q and o over the tokens, k and v over the frames, the
    core at S x F) and FFN, and the head; its bytes the weights read once.
    A decode step reads only what ``encdec.decode_step`` reads: each
    decoder layer's self-attention, its cross-attention's q and o (the
    cross k and v projections ran once, in ``prefill_cross``), its FFN and
    norms, the final norm and the head, but no encoder weight and the
    embedding table only for a few rows; and the ``valid`` slots of every
    layer's self-attention K and V and every layer's cross K and V over the
    frames (bytes)."""
    d, h, kv, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.frontend_len
    attn = 2 * d * h * hd + 2 * d * kv * hd  # q, o; k, v
    ffn = cfg._ffn_params(cfg.d_ff)
    encoder = cfg.encoder_layers * (f * 2 * (attn + ffn) + 4 * h * f * f * hd)
    self_attn = s * 2 * attn + 4 * h * s * s // 2 * hd
    cross = s * 2 * 2 * d * h * hd + f * 2 * 2 * d * kv * hd + 4 * h * s * f * hd
    ops = encoder + cfg.num_layers * (self_attn + cross + s * 2 * ffn) + 2 * s * d * cfg.vocab_size
    weights = 2 * cfg.param_count()
    prefill = bound_ms(weights, ops, PEAK_BF16_OPS_PER_S)
    dec_layer = attn + 2 * d * h * hd + ffn + 3 * d  # self-attention, cross q and o, FFN, norms
    step_bytes = 2 * (cfg.num_layers * dec_layer + d * cfg.vocab_size + d)
    step_bytes += cfg.num_layers * batch * (valid + f) * 2 * kv * hd * 2
    return dict(prefill_bound_ms=prefill[0], prefill_bound_by=prefill[1], prefill_ops=ops,
                encoder_ops=encoder, head_ops=2 * s * d * cfg.vocab_size,
                step_bound_ms=step_bytes / PEAK_BYTES_PER_S * 1e3, step_bytes=step_bytes,
                weight_bytes=weights)


def attention_calls(cfg) -> int:
    """Attention applications in one forward or decode step: every layer of
    an attention model, the hybrid's shared block once per group of
    ``hybrid_attn_every`` SSM layers, none in the SSM."""
    if cfg.arch_type == "ssm":
        return 0
    if cfg.arch_type == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    return cfg.num_layers


def ssm_row_bounds(cfg, s, batch, cache_len):
    """The least time a prefill of B 1 x ``s`` tokens and a decode step at
    ``batch`` of an SSM or hybrid row could take on the card.  The prefill's
    operations are those the chunked SSD does as written (its full Q x Q
    intra-chunk products, the chunk states, the inter-chunk read-out), the
    weight GEMMs, the shared block's (the causal attention core at half of
    S x S) and the head, at the bf16 peak; its bytes the weights read once.
    A decode step reads every weight, reads and writes every layer's f32
    recurrent state, and reads the shared caches' valid half at most."""
    d, di, n, h, q = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_chunk
    per_token = 2 * d * (2 * di + 2 * n + h) + 2 * di * d  # in_proj, out_proj
    per_token += 2 * q * n + 2 * q * di + 4 * di * n  # scores, weights x, states, read-out
    ops = cfg.num_layers * s * per_token + 2 * s * d * cfg.vocab_size
    calls = attention_calls(cfg)
    shared_cache = 0
    if calls:
        hd, heads, kv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        block = 2 * 2 * d * d + 2 * d * (heads + 2 * kv) * hd + 2 * heads * hd * d
        block += 2 * cfg._ffn_params(cfg.d_ff)
        ops += calls * (s * block + 4 * heads * s * s // 2 * hd)
        shared_cache = calls * batch * cache_len * 2 * kv * hd * 2 // 2  # bf16 k, v; half valid
    weights = 2 * cfg.param_count()
    prefill = bound_ms(weights, ops, PEAK_BF16_OPS_PER_S)
    state = cfg.num_layers * batch * h * cfg.ssm_head_dim * n * 4
    return dict(prefill_bound_ms=prefill[0], prefill_bound_by=prefill[1], prefill_ops=ops,
                step_bound_ms=(weights + 2 * state + shared_cache) / PEAK_BYTES_PER_S * 1e3,
                weight_bytes=weights, state_bytes=state)


class BlockRecorder:
    """Records the output of every block a forward or decode step runs, in
    order, while it is entered: each Mamba-2 block's and each application
    of the hybrid's shared block (through their module attributes)."""

    def __enter__(self):
        import repro_torch.models.ssm as ssm
        import repro_torch.models.transformer as tr

        self.saved, self.calls = [], []
        for mod, name in ((ssm, "mamba2_forward"), (ssm, "mamba2_decode_step"), (tr, "_shared_block")):
            real = getattr(mod, name)

            def recording(*a, _real=real, _name=name, **kw):
                res = _real(*a, **kw)
                self.calls.append((_name, (res[0] if isinstance(res, tuple) else res).detach().clone()))
                return res

            self.saved.append((mod, name, real))
            setattr(mod, name, recording)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def first_parting_block(want, got, tol):
    """Where two runs' recorded blocks (``BlockRecorder.calls`` of the same
    blocks in the same order) first part: every block's max error up to the
    first with an entry beyond ``tol + tol * |want|``, and that block."""
    errs = []
    for j, ((name, w), (_, g)) in enumerate(zip(want, got)):
        diff = (g.float() - w.float()).abs()
        errs.append(dict(block=j, name=name, max_abs_err=float(diff.max()),
                         over_tol=int((diff > tol + tol * w.float().abs()).sum())))
        if errs[-1]["over_tol"]:
            return dict(first=errs[-1], blocks=errs)
    return dict(first=None, blocks=errs)


def decode_blocks(model, params, cfg, tokens):
    """The blocks of a forward over ``tokens`` (B, T), recorded, and those
    of T decode steps over them, each block's T outputs stacked, in the
    forward's order."""
    import torch

    with BlockRecorder() as fwd:
        model.forward(params, cfg, {"tokens": tokens})
    cache = model.init_cache(cfg, tokens.shape[0], tokens.shape[1], tokens.device)
    with BlockRecorder() as dec:
        for i in range(tokens.shape[1]):
            model.decode_step(params, cfg, {"tokens": tokens[:, i:i + 1]}, cache, i)
    per = len(fwd.calls)
    stepped = [(name, torch.cat([dec.calls[i * per + j][1] for i in range(tokens.shape[1])], dim=1))
               for j, (name, _) in enumerate(fwd.calls)]
    return fwd.calls, stepped


#: a MoE row's f32 checks run on its first layers only, after the bf16
#: model is freed: 8 dbrx layers upcast to f32 would be 109 GB
F32_LAYERS = 2

#: the bytes of the card's memory :func:`check_cuts` leaves to what its
#: reckoning does not see (the forward's other transients, the
#: allocator's slack): nemotron-4's f32 checks on 1 layer at S 2048 peaked
#: at 71.0 GB on the H100, 9.9 GB above their 61.1 GB reckoned
CHECK_HEADROOM = 16e9


def check_cuts(cfg, s, memory):
    """The depth of a dense, SSM or encoder-decoder row's f32 checks (its
    decoder layers; the encoder stays whole) and the tokens of its einsum
    and f32 prefills, fitted to ``memory`` bytes (None: no cut): the
    longest of ``s``, s/2, s/4, ... at which the bf16 model and its einsum
    forward fit, and the f32 model at one layer and its; then the most
    layers whose f32 weights fit beside that forward.  A forward of T
    positions (a VLM's image positions with its tokens) is reckoned as its
    f32 scores and probabilities (1 x H x T x T each), an encoder-decoder's
    also its encoder's (F x F) and its cross-attention's (T x F), and three
    f32 logits (T x vocab)."""
    if memory is None:
        return cfg.num_layers, s
    n_img = cfg.frontend_len if cfg.frontend == "vision" else 0
    f = cfg.frontend_len if cfg.is_encoder_decoder else 0

    def need(layers, width, cs):
        t = n_img + cs
        weights = width * dataclasses.replace(cfg, num_layers=layers).param_count()
        scores = 8 * cfg.num_heads * (t * t + f * f + t * f)
        return weights + scores + 12 * t * cfg.vocab_size

    cs = s
    while cs > 1 and max(need(cfg.num_layers, 2, cs), need(1, 4, cs)) > memory:
        cs //= 2
    nl = max((n for n in range(1, cfg.num_layers + 1) if need(n, 4, cs) <= memory), default=1)
    return nl, cs


def row_bounds(cfg, scale):
    """A serving row's prefill and decode-step bounds by its family: a MoE
    row's :func:`moe_row_bounds`, an SSM or hybrid row's
    :func:`ssm_row_bounds` (the hybrid's shared attention included), an
    encoder-decoder row's :func:`encdec_row_bounds`, else
    :func:`dense_row_bounds` (a VLM's prefill over its image positions
    too)."""
    s, b = scale["prefill_s"], scale["batch"]
    if cfg.is_encoder_decoder:
        return encdec_row_bounds(cfg, s, b, scale["prompt"] + scale["gen"] - 1)
    if cfg.num_experts:
        return moe_row_bounds(cfg, s, b, scale["context"])
    if cfg.arch_type in ("ssm", "hybrid"):
        return ssm_row_bounds(cfg, s, b, scale["context"])
    n_img = cfg.frontend_len if cfg.frontend == "vision" else 0
    return dense_row_bounds(cfg, n_img + s, b, scale["prompt"] + scale["gen"] - 1)

#: a MoE row holds stepped decode to the forward on one sequence of this
#: many tokens (half prompt, half generated), where ``capacity_of`` equals
#: the token count and no expert can overflow on either path
STEP_TOKENS = 8


def serve_row(device, scale):
    """Serve one config of phase 5 in bf16 on random weights from a seeded
    ``torch.Generator`` on the card, at full width and ``scale["layers"]``
    of its layers (all when unset) of ``scale["config"]`` where given, else
    of ``scale["arch"]``'s full or reduced config.  Returns the row and the
    kernel launches it expects.

    (e) A prefill forward of B 1 x ``prefill_s`` tokens, after the vision
    stub's ``frontend_len`` image positions in a VLM row.  GQA takes the
    flash branch (sdpa's default on CUDA): K6 in every layer, each
    layer's output held to the plain version on that layer's own q/k/v
    (3e-2; 1e-2 relative per query tile), and two flash forwards bitwise
    equal.  MLA takes the einsum path (F7), no kernel.  No prefill may
    beat its bound (:func:`row_bounds`); a dense row also runs the einsum
    path's forward (``REPRO_USE_FLASH=0``) on the first tokens that
    :func:`check_cuts` fits to the card, against the same positions of the
    flash logits.  (f)
    ``greedy_generate`` at B ``batch``, ``prompt`` + ``gen`` tokens, and one
    forward of them; for GQA, K7 launched on layer 0's final cache with the
    last step's q, held to its plain version and to the einsum ``sdpa``
    (3e-2).

    The whole-model checks run on the same weights upcast to f32, where
    rounding does not swamp them: a MoE row on its first ``F32_LAYERS``
    layers, a dense or SSM row on as many layers and prefill tokens as
    :func:`check_cuts` fits to the card (all of both where they fit).
    They see the routing: each MoE layer's expert choices are recorded on
    both paths, every flip must be a near tie (:func:`routing_diff`), and
    the logits are held at 1e-4 before the first token routed differently
    (everywhere, in a dense row).  The flash
    forward is held to the einsum forward (GQA).  Stepped decode is held to
    the forward where no expert can overflow: the whole B x (prompt + gen)
    run of a dense row; for a MoE row one sequence of ``STEP_TOKENS``
    (stepped decode and the forward use different capacities by design, in
    the reference too), and the longer run is reported with the choices its
    forward dropped.  In bf16 the two paths of a 32-layer model differ by up
    to ~0.08 — as far as the einsum path itself is from the f32 forward —
    so a dense row's bf16 comparisons (with each path's distance from the
    f32 forward) are reported, not enforced."""
    import collections
    import os

    import torch

    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.flash_decode as fd
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import get_model
    from repro_torch.models.mlp import capacity_of
    from repro_torch.serve import ServeConfig, greedy_generate, init_serving_cache, make_serve_step

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    base = scale.get("config") or (get_reduced if scale["reduced"] else get_config)(scale["arch"])
    cfg = dataclasses.replace(base, num_layers=scale.get("layers") or base.num_layers)
    model = get_model(cfg)
    encdec = cfg.is_encoder_decoder
    calls = attention_calls(cfg)  # K6 launches per flash forward (an encoder-decoder's: its decoder's)
    gqa, moe, ssm = calls > 0 and not cfg.use_mla, bool(cfg.num_experts), cfg.arch_type in ("ssm", "hybrid")
    k = cfg.num_experts_per_token
    s = scale["prefill_s"]
    if moe:
        nl, cs = min(F32_LAYERS, cfg.num_layers), s
    else:  # cs: the tokens of the einsum and f32 prefills
        memory = torch.cuda.get_device_properties(device).total_memory - CHECK_HEADROOM if cuda else None
        nl, cs = check_cuts(cfg, s, memory)
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=nl)
    # the bf16 logits are held to the f32 forward only where it is the same model on the same tokens
    whole32 = nl == cfg.num_layers and cs == s
    reduced = ((f"{cfg.num_layers} of {base.num_layers} layers" if cfg.num_layers < base.num_layers
                else "full depth") + (f"; the f32 checks on the first {nl}" if nl < cfg.num_layers else "")
               + (f"; the einsum and f32 prefills on the first {cs} tokens" if cs < s else ""))
    out = dict(model=cfg.name, layers=cfg.num_layers, full_layers=base.num_layers, reduced=reduced,
               d_model=cfg.d_model, dtype=cfg.dtype, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
               experts=cfg.num_experts, top_k=k, shared_experts=cfg.num_shared_experts,
               mla=cfg.use_mla, param_count=cfg.param_count(), head_dim=cfg.head_dim,
               attention_calls=calls, qk_norm=cfg.qk_norm, mrope=cfg.mrope, mlp=cfg.mlp_type,
               attention="flash (K6)" if gqa else ("einsum (F7)" if cfg.use_mla else "none (SSM)"))
    if ssm:
        out.update(arch_type=cfg.arch_type, ssm_heads=cfg.ssm_heads, ssm_state=cfg.ssm_state,
                   ssm_chunk=cfg.ssm_chunk, hybrid_attn_every=cfg.hybrid_attn_every)
    if encdec:
        out.update(encoder_layers=cfg.encoder_layers, frames=cfg.frontend_len,
                   encoder_attention="einsum (non-causal)", cross_attention="einsum (non-causal)")
    expect = dict(flash_attention=0, flash_decode=0)
    # on the card the flash branch is sdpa's default at D 128; the CPU
    # rehearsal forces it for GQA (MLA has no flash branch, F7)
    flash_env = None if cuda else ("1" if gqa else "0")
    saved_env = os.environ.get("REPRO_USE_FLASH")

    def set_flash(value):
        if value is None:
            os.environ.pop("REPRO_USE_FLASH", None)
        else:
            os.environ["REPRO_USE_FLASH"] = value

    def forward(p, c, tokens, flash=True, images=None, frames=None):
        """Logits and seconds of one forward (``images`` the vision stub's
        embeddings, prepended; ``frames`` an encoder-decoder's audio frames,
        zeros when not given: the function ``greedy_generate`` steps, D15);
        K6's launches checked."""
        set_flash(flash_env if flash else "0")
        n0 = fa.flash_attention.launches
        batch = {"tokens": tokens} if images is None else {"tokens": tokens, "image_embeds": images}
        if encdec:
            batch["audio_frames"] = frames if frames is not None else torch.zeros(
                (tokens.shape[0], c.frontend_len, c.d_model), device=tokens.device)
        sync()
        t = time.perf_counter()
        logits, _ = model.forward(p, c, batch)
        sync()
        dt = time.perf_counter() - t
        check(bool(torch.isfinite(logits).all()), f"{c.name} {c.dtype} forward: logits are not finite")
        want = attention_calls(c) if (flash and gqa and cuda) else 0
        expect["flash_attention"] += want
        if c.dtype == "float32":  # K6's f32 instance: the f32 checks
            out["k6_f32_launches"] = out.get("k6_f32_launches", 0) + want
        if cuda:
            check(fa.flash_attention.launches - n0 == want,
                  f"{c.name} forward: K6 launched {fa.flash_attention.launches - n0} times, wanted {want}")
        return logits, dt

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0), cfg)
    sync()
    out["init_s"] = time.perf_counter() - t0
    if cuda:
        out["weights_gb"] = torch.cuda.memory_allocated() / 1e9
    gen = torch.Generator(device=device).manual_seed(1)
    orig_sdpa = attention.sdpa
    try:
        # ---- (e) prefill ---------------------------------------------------- #
        tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=device)
        image, n_img = None, 0
        if cfg.frontend == "vision":  # the stub's patch embeddings: rows of the embedding table
            n_img = cfg.frontend_len
            image = params["embed"][torch.randint(0, cfg.vocab_size, (1, n_img), generator=gen,
                                                  device=device)]
            out.update(image_positions=n_img)
        frames = None
        if encdec:  # the audio stub's frame embeddings, at batch_for's scale
            frames = torch.randn((1, cfg.frontend_len, cfg.d_model), generator=gen, device=device) * 0.02
        with RouteRecorder() as routes:
            logits, out["prefill_s"] = forward(params, cfg, tokens, images=image, frames=frames)
        out["prefill_tokens_per_s"] = (n_img + s) / out["prefill_s"]
        check(tuple(logits.shape) == (1, n_img + s, cfg.vocab_size), f"prefill logits {tuple(logits.shape)}")
        out.update(row_bounds(cfg, scale))
        if moe:
            out.update(capacity=capacity_of(cfg, s), prefill_dropped_choices=routes.dropped(),
                       prefill_choices=s * k * cfg.num_layers)
        check(out["prefill_s"] * 1e3 >= out["prefill_bound_ms"],
              f"{cfg.name}: a prefill of {out['prefill_s']} s is under its bound "
              f"({out['prefill_bound_ms']} ms): it skipped work")
        if gqa:
            layer_errs = []

            def checked_sdpa(q, k_, v, causal, q_offset=None, kv_valid_len=None):
                res = orig_sdpa(q, k_, v, causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
                if causal:  # the flash branch's calls (an encoder's and a cross-attention's are not)
                    want = fa.flash_attention_plain(q, k_, v, causal)
                    b_, s_ = q.shape[:2]
                    layer_errs.append((*logits_close(res.reshape(b_, s_, -1), want.reshape(b_, s_, -1),
                                                     3e-2), rel_err(res, want, 128)))
                return res

            attention.sdpa = checked_sdpa
            again, _ = forward(params, cfg, tokens, images=image, frames=frames)
            attention.sdpa = orig_sdpa
            check(len(layer_errs) == calls,
                  f"{cfg.name} prefill: attention ran {len(layer_errs)} times, wanted {calls}")
            for i, (err, ok, rel) in enumerate(layer_errs):
                check(ok, f"{cfg.name} prefill layer {i}: K6 differs from plain beyond 3e-2 ({err})")
                check(rel <= REL_TOL, f"{cfg.name} prefill layer {i}: a query tile's relative "
                      f"error {rel} > {REL_TOL}")
            out["prefill_layer_max_err"] = max(e for e, _, _ in layer_errs)
            out["prefill_layer_max_rel_err"] = max(r for _, _, r in layer_errs)
            check(torch.equal(again, logits), f"{cfg.name} prefill: two flash forwards differ")
            del again
        if moe or not gqa:  # the bf16 logits are compared with nothing (a cut depth, no attention)
            del logits
        else:
            einsum_logits, out["prefill_einsum_s"] = forward(params, cfg, tokens[:, :cs], flash=False,
                                                             images=image, frames=frames)
            out["bf16_prefill_vs_einsum"] = dict(logits_stats(logits[:, :n_img + cs], einsum_logits, 0.05),
                                                 tokens=cs)
            if not whole32:  # the f32 forward is another model or other tokens
                del logits, einsum_logits
        out["profile_prefill"] = profile_window(
            lambda: forward(params, cfg, tokens, images=image, frames=frames), device)

        # ---- (f) greedy serving --------------------------------------------- #
        b, p, n = scale["batch"], scale["prompt"], scale["gen"]
        prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device=device)
        sc = ServeConfig(batch_size=b, context_len=scale["context"])
        captured = collections.deque(maxlen=max(calls, 1))  # the last step's attention calls (GQA)

        def recording_sdpa(q, k_, v, causal, q_offset=None, kv_valid_len=None):
            res = orig_sdpa(q, k_, v, causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
            if kv_valid_len is not None:
                captured.append((q, k_, v, kv_valid_len, res))
            return res

        attention.sdpa = recording_sdpa
        set_flash(flash_env)
        steps = p + n - 1
        sync()
        t0 = time.perf_counter()
        seq, step_logits = greedy_generate(params, cfg, prompt, n, sc, return_logits=True)
        sync()
        attention.sdpa = orig_sdpa
        out.update(generate_s=time.perf_counter() - t0, steps=steps, batch=b,
                   cache_len=sc.cache_len(cfg))
        out["step_ms"] = out["generate_s"] / steps * 1e3
        out["decode_tokens_per_s"] = b * steps / out["generate_s"]
        check(tuple(seq.shape) == (b, p + n), f"{cfg.name}: generated {tuple(seq.shape)}")
        check(bool(torch.isfinite(step_logits).all()), f"{cfg.name}: stepped logits are not finite")
        with RouteRecorder() as routes:
            full, _ = forward(params, cfg, seq)
        out["bf16_decode_vs_forward"] = logits_stats(step_logits, full[:, :-1], 0.05)
        if moe:
            out["bf16_decode_vs_forward"].update(tokens=b * (p + n), capacity=capacity_of(cfg, b * (p + n)),
                                                 forward_dropped_choices=routes.dropped())
            del step_logits
        del full
        cache = init_serving_cache(cfg, sc, device)
        out["serving_cache_bytes"] = sum(t.numel() * t.element_size() for _, t in _leaf_paths(cache))
        serve_step = make_serve_step(cfg)
        out["profile_decode_3_steps"] = profile_window(
            lambda: [serve_step(params, seq[:, i:i + 1], cache, i) for i in range(steps - 3, steps)],
            device)
        del cache
        if gqa:  # K7 on layer 0's served cache, with the last step's q
            q, kc, vc, valid, einsum_out = captured[0]
            check(valid == steps, f"{cfg.name}: the last step's valid_len {valid}, wanted {steps}")
            n0 = fd.flash_decode.launches
            got = fd.flash_decode(q[:, 0], kc, vc, valid)
            expect["flash_decode"] += 1
            if cuda:
                check(fd.flash_decode.launches - n0 == 1, f"{cfg.name}: K7 did not launch")
            want = fd.flash_decode_plain(q[:, 0], kc, vc, valid)
            err_plain, ok_plain = logits_close(got, want, 3e-2)
            rel_plain = rel_err(got, want)
            err_sdpa, ok_sdpa = logits_close(got, einsum_out[:, 0], 3e-2)
            check(ok_plain, f"{cfg.name}: K7 on layer 0's cache differs from plain ({err_plain})")
            check(rel_plain <= REL_TOL, f"{cfg.name}: K7 on layer 0's cache: a head's relative "
                  f"error {rel_plain} > {REL_TOL}")
            check(ok_sdpa, f"{cfg.name}: K7 on layer 0's cache differs from sdpa ({err_sdpa})")
            out.update(k7_shape=[b, sc.cache_len(cfg), cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim, valid],
                       k7_plan=fd.launch_plan(tuple(q[:, 0].shape), tuple(kc.shape), kc.dtype),
                       k7_group=cfg.num_heads // cfg.num_kv_heads, k7_vs_plain_max_err=err_plain,
                       k7_vs_plain_rel_err=rel_plain, k7_vs_sdpa_max_err=err_sdpa)
            del q, kc, vc, einsum_out, got, want
        del captured
        if cuda:
            out["bf16_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

        # ---- the whole-model checks, on the same weights in f32 ------------- #
        del params["dec_layers" if encdec else "layers"][nl:]
        if cuda:
            torch.cuda.empty_cache()
        params32 = _upcast(params)
        del params
        if cuda:
            torch.cuda.empty_cache()
        if gqa:  # the flash forward against the einsum forward
            tokens32 = tokens[:, :cs]
            with RouteRecorder() as ref_routes:
                ref, _ = forward(params32, cfg32, tokens32, flash=False, images=image, frames=frames)
            if not moe and whole32:
                out["bf16_prefill_flash_vs_f32"] = logits_stats(logits, ref, 0.05)
                out["bf16_prefill_einsum_vs_f32"] = logits_stats(einsum_logits, ref, 0.05)
                del logits, einsum_logits
            if cuda:
                torch.cuda.synchronize()
            t32 = time.perf_counter()
            with RouteRecorder() as flash_routes:
                flash32, _ = forward(params32, cfg32, tokens32, images=image, frames=frames)
            if cuda:
                torch.cuda.synchronize()
            out["f32_flash_prefill_s"] = time.perf_counter() - t32  # K6's f32 instance on a gqa row
            diff = routing_diff(ref_routes.calls, flash_routes.calls, k)
            n32 = n_img + cs  # positions of the f32 prefill
            cut = n32 if diff["cut"] is None else diff["cut"]
            held = logits_stats(flash32[:, :cut], ref[:, :cut], 1e-4) if cut else None
            out["f32_prefill_vs_einsum"] = dict(
                routing=diff, tokens=n32, positions_held=cut, held=held,
                after_cut=logits_stats(flash32[:, cut:], ref[:, cut:], 1e-4) if cut < n32 else None,
                dropped_choices=ref_routes.dropped())
            check(not diff["not_near_ties"], f"{cfg.name} f32 prefill: routing moved away from a "
                  f"near tie (margin > {NEAR_TIE}): {diff['not_near_ties']}")
            if held is not None and held["over_tol"] and ssm:  # the first block the two paths part at
                with BlockRecorder() as ref_blocks:
                    forward(params32, cfg32, tokens32, flash=False)
                with BlockRecorder() as flash_blocks:
                    forward(params32, cfg32, tokens32)
                parting = first_parting_block(ref_blocks.calls, flash_blocks.calls, 1e-4)
                out["f32_prefill_first_parting_block"] = parting
                log(f"[serve] {cfg.name} f32 flash vs einsum prefill parts at " + json.dumps(parting))
                del ref_blocks, flash_blocks
            check(held is None or held["over_tol"] == 0,
                  f"{cfg.name} f32 prefill: flash logits differ from the einsum path's beyond 1e-4 "
                  f"where routing agrees ({held})")
            del flash32, ref, tokens32

        set_flash(flash_env)
        if moe:  # stepped decode against the forward where no expert can overflow
            m = STEP_TOKENS - 1  # the stepped logits' positions
            short = ServeConfig(batch_size=1, context_len=STEP_TOKENS)
            check(capacity_of(cfg32, STEP_TOKENS) == STEP_TOKENS,
                  f"{cfg.name}: capacity_of({STEP_TOKENS}) is {capacity_of(cfg32, STEP_TOKENS)}")
            with RouteRecorder() as step_routes:
                seq8, steps8 = greedy_generate(params32, cfg32, prompt[:1, :STEP_TOKENS // 2],
                                               STEP_TOKENS // 2, short, return_logits=True)
            with RouteRecorder() as fwd_routes:
                full8, _ = forward(params32, cfg32, seq8)
            per_step = [[step_routes.calls[i * nl + layer] for i in range(m)] for layer in range(nl)]
            stepped = [dict(probs=torch.cat([c["probs"] for c in calls]),
                            experts=torch.cat([c["experts"] for c in calls]),
                            keep=torch.cat([c["keep"] for c in calls])) for calls in per_step]
            fwd = [dict(probs=c["probs"][:m], experts=c["experts"][:m], keep=c["keep"][:m])
                   for c in fwd_routes.calls]
            diff = routing_diff(fwd, stepped, k)
            cut = m if diff["cut"] is None else diff["cut"]
            held = logits_stats(steps8[:, :cut], full8[:, :cut], 1e-4) if cut else None
            dropped = step_routes.dropped() + fwd_routes.dropped()
            out["f32_decode_vs_forward"] = dict(routing=diff, tokens=STEP_TOKENS, positions_held=cut,
                                                held=held, dropped=dropped)
            check(not diff["not_near_ties"], f"{cfg.name} f32 decode: routing moved away from a "
                  f"near tie: {diff['not_near_ties']}")
            check(dropped == 0, f"{cfg.name} f32 decode: a choice was dropped at {STEP_TOKENS} tokens")
            check(held is None or held["over_tol"] == 0,
                  f"{cfg.name} f32 decode: stepped logits differ from the forward's beyond 1e-4 ({held})")
            del seq8, steps8, full8
        # the whole B x (prompt + gen) run: held in a dense row, reported in a
        # MoE row, whose forward may drop choices the stepped run keeps
        seq32, steps32 = greedy_generate(params32, cfg32, prompt, n, sc, return_logits=True)
        check(torch.equal(seq32[:, :p], prompt), "f32 serving lost the prompt")
        with RouteRecorder() as routes:
            full32, _ = forward(params32, cfg32, seq32)
        st = logits_stats(steps32, full32[:, :-1], 1e-4)
        if moe:
            out["f32_long_decode_vs_forward"] = dict(st, tokens=b * (p + n),
                                                     forward_dropped_choices=routes.dropped())
        else:
            out["f32_decode_vs_forward"] = st
            if st["over_tol"] and ssm:  # where the recurrence and the chunked SSD part
                out["f32_decode_first_parting_block"] = first_parting_block(
                    *decode_blocks(model, params32, cfg32, seq32), 1e-4)
                log(f"[serve] {cfg.name} f32 decode vs forward parts at "
                    + json.dumps(out["f32_decode_first_parting_block"]))
            check(st["over_tol"] == 0, f"f32 decode parity: stepped logits differ from the "
                  f"forward's beyond 1e-4 ({st})")
            if nl == cfg.num_layers and torch.equal(seq32, seq):
                out["bf16_steps_vs_f32_forward"] = logits_stats(step_logits, full32[:, :-1], 0.05)
            del step_logits
        if encdec:  # the cross K/V of prefill_cross, then decode_step, against the forward
            del steps32, full32
            frames_b = torch.randn((b, cfg.frontend_len, cfg.d_model), generator=gen, device=device) * 0.02
            full32, _ = forward(params32, cfg32, seq32, frames=frames_b)
            cache = model.init_cache(cfg32, b, p + n, device)
            cache["cross_k"], cache["cross_v"] = model.prefill_cross(
                params32, cfg32, model.encode(params32, cfg32, frames_b))
            steps32 = torch.cat([model.decode_step(params32, cfg32, {"tokens": seq32[:, i:i + 1]}, cache, i)[0]
                                 for i in range(steps)], dim=1)
            st = logits_stats(steps32, full32[:, :-1], 1e-4)
            out["f32_cross_decode_vs_forward"] = st
            check(st["over_tol"] == 0, f"{cfg.name} f32 prefill_cross + decode_step: stepped logits "
                  f"differ from the forward's on the same frames beyond 1e-4 ({st})")
            del cache, frames_b
        del seq32, steps32, full32, params32
    finally:
        attention.sdpa = orig_sdpa
        set_flash(saved_env)
    if cuda:
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
    f32p, f32d = out.get("f32_prefill_vs_einsum"), out["f32_decode_vs_forward"]
    log(f"[serve] {cfg.name} ({reduced}), prefill S={n_img + s}: {out['prefill_s']:.3f} s"
        + f" (bound {out['prefill_bound_ms']:.1f} ms, {out['prefill_bound_by']})"
        + (f", {out['prefill_dropped_choices']} of {out['prefill_choices']} choices dropped" if moe else "")
        + f"; decode step {out['step_ms']:.1f} ms at B {b}"
        + f" (bound {out['step_bound_ms']:.1f} ms)"
        + (f"; per-call K6 max err {out['prefill_layer_max_err']:.3g} (worst tile's relative error "
           f"{out['prefill_layer_max_rel_err']:.3g}); K7 (group {out['k7_group']}, valid "
           f"{out['k7_shape'][-1]}) vs plain {out['k7_vs_plain_max_err']:.3g} (relative "
           f"{out['k7_vs_plain_rel_err']:.3g}), vs sdpa {out['k7_vs_sdpa_max_err']:.3g}" if gqa else "")
        + (f"; f32 flash prefill {out['f32_flash_prefill_s']:.3f} s vs einsum: "
           f"{f32p['routing']['flips']} flips, "
           f"{f32p['routing']['reorders']} reorders (+{f32p['routing']['downstream']} "
           f"downstream), {f32p['positions_held']} of "
           f"{f32p['tokens']} positions held at 1e-4, max err "
           f"{(f32p['held'] or {}).get('max_abs_err')}" if f32p else "")
        + (f"; f32 decode vs forward at {STEP_TOKENS} tokens: {f32d['routing']['flips']} flips, "
           f"{f32d['routing']['reorders']} reorders, "
           f"max err {(f32d['held'] or {}).get('max_abs_err')}" if moe
           else f"; f32 decode parity {f32d['max_abs_err']:.3g}")
        + (f"; f32 prefill_cross + decode vs forward {out['f32_cross_decode_vs_forward']['max_abs_err']:.3g}"
           if encdec else "")
        + (f"; bf16 flash vs einsum {out['bf16_prefill_vs_einsum']['max_abs_err']:.3g}"
           if not moe and gqa else ""))
    log("[serve] " + json.dumps(out))
    return out, expect


# --------------------------------------------------------------------------- #
# phase 7: training llama3-8b
# --------------------------------------------------------------------------- #
def _kernel_groups(top):
    """Device time of a profile's kernels by kind (GEMM, copy, softmax,
    reductions, elementwise, other) — the names are cuBLAS's and PyTorch's."""
    groups = {}
    for k in top:
        name = k["name"].lower()
        kind = ("gemm" if any(w in name for w in ("gemm", "cutlass", "xmma", "nvjet", "sm90_"))
                else "copy" if "memcpy" in name
                else "softmax" if "softmax" in name
                else "reduce" if "reduce" in name
                else "elementwise" if any(w in name for w in ("elementwise", "vectorized", "unrolled"))
                else "other")
        groups[kind] = groups.get(kind, 0.0) + k["ms"]
    return groups


def op_recorder():
    """A ``TorchDispatchMode`` that logs every aten op run under it, the
    backward's included (the autograd engine carries the mode to its
    threads): its name, call index, whether it ran on the backward's
    thread, each tensor input's dtype, shape, strides and ``data_ptr() %
    256`` (the alignment cuBLAS picks kernels by), and a checksum of its
    outputs' bytes computed on their device (two int64 sums, one weighted
    by position; none for an op that only allocates), so the log costs one
    read-back at the end."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def describe(t):
        try:
            ptr = t.data_ptr() % 256
        except RuntimeError:
            ptr = None
        return dict(dtype=str(t.dtype).replace("torch.", ""), shape=list(t.shape),
                    stride=list(t.stride()), ptr256=ptr)

    def checksum(t):
        t = t.detach()
        if t.numel() == 0 or t.is_sparse:
            return torch.zeros(2, dtype=torch.int64, device=t.device)
        b = t.contiguous().reshape(-1).view(torch.uint8)
        if b.numel() % 4 == 0:
            b = b.view(torch.int32)
        b = b.to(torch.int64)
        return torch.stack([b.sum(), (b * torch.arange(1, b.numel() + 1, device=b.device)).sum()])

    class OpRecord(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.sums = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [describe(a) for a in tree_flatten((args, kwargs))[0] if torch.is_tensor(a)]
            outs = [o for o in tree_flatten(out)[0] if torch.is_tensor(o)]
            if "empty" in func.__name__:  # memory not yet written
                outs = []
            self.ops.append(dict(op=str(func), backward=torch._C._current_graph_task_id() != -1,
                                 inputs=ins))
            self.sums.append([checksum(o) for o in outs])
            return out

        def read(self):
            """The checksums on the host: one list of (sum, weighted sum) per op."""
            return [[tuple(int(v) for v in s.cpu()) for s in sums] for sums in self.sums]

    return OpRecord()


def first_moved_op(rec_a, rec_b, sums_a, sums_b):
    """The first op whose outputs differ between two recorded runs of the
    same program (``None`` if none does), with both runs' inputs, and how
    many ops differ in all."""
    if [o["op"] for o in rec_a.ops] != [o["op"] for o in rec_b.ops]:
        k = next((i for i, (x, y) in enumerate(zip(rec_a.ops, rec_b.ops)) if x["op"] != y["op"]),
                 min(len(rec_a.ops), len(rec_b.ops)))
        return dict(index=k, ops=[len(rec_a.ops), len(rec_b.ops)], reason="the op sequences differ",
                    first=rec_a.ops[k]["op"] if k < len(rec_a.ops) else None,
                    second=rec_b.ops[k]["op"] if k < len(rec_b.ops) else None)
    moved = [i for i, (x, y) in enumerate(zip(sums_a, sums_b)) if x != y]
    if not moved:
        return None
    k = moved[0]
    return dict(index=k, ops=len(sums_a), ops_moved=len(moved),
                first_backward_op=next((i for i, o in enumerate(rec_a.ops) if o["backward"]), None),
                op=rec_a.ops[k]["op"], backward=rec_a.ops[k]["backward"],
                inputs_first=rec_a.ops[k]["inputs"], inputs_second=rec_b.ops[k]["inputs"],
                next_moved=[dict(index=i, op=rec_a.ops[i]["op"]) for i in moved[1:4]])


def train_loop_check(device, arch, f):
    """Phase 7 (d): ``train_loop`` on ``arch``'s reduced config in f32, ``f``
    steps/batch/seq, twice on ``device`` and twice on the host's CPU on one
    thread, then once on the host's thread pool.  The first run of the
    device is held to the first of the host: losses within 1e-5 relative,
    params within 1e-5 relative L2 as a whole.  Logged before the checks:
    each leaf's error, each run's sum of squares, whether each side's second
    run is bitwise equal to its first, the element that differs most
    between the sides, and the pool run's distance from the one-thread run,
    so a run that fails shows which side moved.  The reference runs on one
    thread because a thread pool's sums need not take the same order from
    one run to the next, and Adam's g / (|g| + eps) magnifies a rounding
    change in a gradient near eps up to a step of lr."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import train_loop
    from repro_torch.train.optimizer import tree_leaves

    cfg32 = dataclasses.replace(get_reduced(arch), dtype="float32")
    cpu = torch.device("cpu")
    runs = []  # the device's two runs, the host's two on one thread, the pool's
    threads = torch.get_num_threads()
    records = []  # the device's two runs, op by op
    for where, one_thread in ((device, False), (device, False), (cpu, True), (cpu, True),
                              (cpu, False)):
        if one_thread:
            torch.set_num_threads(1)
        rec = op_recorder() if len(records) < 2 else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with rec:
                st, losses = train_loop(cfg32, steps=f["steps"], batch_size=f["batch"],
                                        seq_len=f["seq"], log_every=10**9, device=where)
        finally:
            torch.set_num_threads(threads)
        if len(records) < 2:
            records.append((rec, rec.read()))
        params = [x.detach().cpu() for x in tree_leaves(st["params"])]
        runs.append((params, losses, time.perf_counter() - t0))
    (rec1, sums1), (rec2, sums2) = records
    moved = first_moved_op(rec1, rec2, sums1, sums2)
    log(f"[train] (d) the device's two runs, op by op ({len(sums1)} ops, "
        f"{sum(o['backward'] for o in rec1.ops)} in the backward): "
        + ("every op's output bitwise equal" if moved is None
           else "the first op whose output differs: " + json.dumps(moved)))
    (pd, ld, td), (pd2, _, _), (ph, lh, th), (ph2, _, _), (pool, _, _) = runs
    paths = [p for p, _ in _leaf_paths(st["params"])]
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(ld, lh))
    leaf_err = {p: _rel_l2(x, y) for p, x, y in zip(paths, pd, ph)}
    diff2 = sum(float((x.double() - y.double()).pow(2).sum()) for x, y in zip(pd, ph))
    norm2 = sum(float(y.double().pow(2).sum()) for y in ph)
    tree_err = (diff2 / norm2) ** 0.5
    worst = max(leaf_err, key=leaf_err.get)
    gaps = [float((x.double() - y.double()).abs().max()) for x, y in zip(pd, ph)]
    k = max(range(len(gaps)), key=gaps.__getitem__)
    idx = int((pd[k].double() - ph[k].double()).abs().argmax())
    out = dict(model=cfg32.name, steps=f["steps"], losses_device=ld,
               losses_host=lh, loss_max_rel_err=loss_err, params_rel_l2=tree_err,
               worst_leaf=worst, worst_leaf_rel_l2=leaf_err[worst], device_s=td, host_s=th,
               params_sq_device=[sum(float(x.double().pow(2).sum()) for x in r[0])
                                 for r in runs[:2]],
               params_sq_host=[sum(float(x.double().pow(2).sum()) for x in r[0])
                               for r in runs[2:]],
               host_pool_threads=threads,
               host_pool_rel_l2=(sum(float((x.double() - y.double()).pow(2).sum())
                                     for x, y in zip(pool, ph)) / norm2) ** 0.5,
               device_repeat_bitwise=all(torch.equal(x, y) for x, y in zip(pd, pd2)),
               host_repeat_bitwise=all(torch.equal(x, y) for x, y in zip(ph, ph2)),
               largest_gap=dict(leaf=paths[k], index=idx, device=float(pd[k].flatten()[idx]),
                                host=float(ph[k].flatten()[idx])),
               leaf_rel_l2=leaf_err, ops_recorded=len(sums1), first_moved_op=moved)
    log(f"[train] (d) f32 train_loop, {device} vs the host: " + json.dumps(out))
    check(loss_err <= 1e-5, f"train (d): f32 losses {ld} on {device} vs {lh} on the host")
    check(tree_err <= 1e-5, f"train (d): f32 params {tree_err} apart (relative L2)")
    return out


def train_phase(device, scale):
    """Train ``llama3-8b`` (bf16 params, f32 AdamW moments, remat "nothing")
    through ``make_train_step`` on random weights from a seeded
    ``torch.Generator`` on the card and data from ``batch_for(seed=0,
    step=i)``: (a) one step with microbatches 1 and one with microbatches 2
    from the same state (finite loss, grad norms within 1e-2 relative, every
    leaf a nonzero gradient — each layer's wq/wk/wv included — read from the
    first moment, every parameter moved, no flash launch, and
    ``REPRO_USE_FLASH=1`` raising under grad); (b) 1 warm and ``timed_steps``
    timed steps: step ms, tokens/s, ``train_mfu`` (6·N·T over the step time
    and 989 TFLOP/s), peak memory, and two profiler windows of one step
    each, the second reported (busy share, kernels by name and kind); (c) the
    migration path: ``save_checkpoint`` into a temporary directory (removed
    afterwards), ``restore_checkpoint`` into a fresh state (bitwise equal to
    the saved one), the next step of the uninterrupted run and the first
    step after the restore (losses within 1e-6 relative; whether they are
    bitwise equal is printed), beside ``MIGRATION_OVERHEAD_S``; (d)
    :func:`train_loop_check`, the f32 ``train_loop`` card against host."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import repro_torch.kernels.flash_attention as fa
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.jobs import MIGRATION_OVERHEAD_S, migration_overhead_s
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.data import batch_for, to_device
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    from repro_torch.train.step import TrainConfig, make_train_step, train_state_init

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = (get_reduced if scale["reduced"] else get_config)(scale["arch"])
    full_layers = cfg.num_layers
    if scale["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=scale["layers"])
    b, s = scale["batch"], scale["seq"]
    tokens = b * s
    steps_total = 2 + 1 + scale["timed_steps"] + 2 + 2  # (a) + warm + timed + profiles + (c)
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=max(steps_total // 10, 1))
    tc1, tc2 = TrainConfig(optimizer=opt), TrainConfig(optimizer=opt, microbatches=2)
    step1, step2 = make_train_step(cfg, tc1), make_train_step(cfg, tc2)
    out = dict(model=cfg.name, layers=cfg.num_layers, full_layers=full_layers,
               reduced=f"{cfg.num_layers} of {full_layers} layers" if scale["layers"] else None,
               d_model=cfg.d_model, dtype=cfg.dtype, batch=b, seq=s, tokens_per_step=tokens,
               param_count=cfg.param_count(), lr=opt.learning_rate, warmup_steps=opt.warmup_steps)
    batches = [to_device(batch_for(cfg.vocab_size, b, s, seed=0, step=i), device)
               for i in range(steps_total)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    launches0 = fa.flash_attention.launches
    saved_env = os.environ.pop("REPRO_USE_FLASH", None)

    def init(seed):
        state = train_state_init(torch.Generator(device=device).manual_seed(seed), cfg, tc1)
        sync()
        return state

    try:
        # ---- (a) one step at microbatches 1 and 2 from the same state ----- #
        state = init(0)
        before = [p.clone() for p in tree_leaves(state["params"])]
        matmul = sum(p.numel() for path, p in _leaf_paths(state["params"])
                     if p.dim() >= 2 and path != "embed")
        out["matmul_params"] = matmul
        out["state_gb"] = sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 1e9
        t0 = time.perf_counter()
        state, m1 = step1(state, batches[0])
        sync()
        out["first_step_s"] = time.perf_counter() - t0
        gn1, loss1 = float(m1["grad_norm"]), float(m1["loss"])
        check(np.isfinite(loss1) and np.isfinite(gn1) and gn1 > 0,
              f"train (a): loss {loss1}, grad norm {gn1}")
        # m = (1 - beta1) * clipped grad after one step from zero moments
        no_grad = [path for path, m in _leaf_paths(state["opt"]["m"]) if not bool(m.abs().max() > 0)]
        check(not no_grad, f"train (a): these leaves got no gradient: {no_grad}")
        qkv = [[bool(layer["attn"][w].abs().max() > 0) for w in ("wq", "wk", "wv")]
               for layer in state["opt"]["m"]["layers"]]
        check(all(all(r) for r in qkv), f"train (a): wq/wk/wv gradients per layer {qkv}")
        unmoved = [path for (path, p), p0 in zip(_leaf_paths(state["params"]), before)
                   if torch.equal(p, p0)]
        check(not unmoved, f"train (a): these parameters did not change: {unmoved}")
        del state, before
        state = init(0)
        state, m2 = step2(state, batches[0])
        sync()
        gn2, loss2 = float(m2["grad_norm"]), float(m2["loss"])
        check(abs(gn2 - gn1) <= 1e-2 * gn1, f"train (a): grad norm {gn1} (microbatches 1) vs {gn2} (2)")
        out["a"] = dict(loss_mb1=loss1, loss_mb2=loss2, grad_norm_mb1=gn1, grad_norm_mb2=gn2,
                        leaves_with_gradient=len(list(_leaf_paths(state["opt"]["m"]))),
                        layers_with_qkv_gradient=len(qkv))
        os.environ["REPRO_USE_FLASH"] = "1"
        small = to_device(batch_for(cfg.vocab_size, 1, 128, seed=0, step=0), device)
        try:
            step1(state, small)
            raised = None
        except RuntimeError as exc:
            raised = str(exc)
        finally:
            os.environ.pop("REPRO_USE_FLASH", None)
        check(raised is not None and "no backward" in raised,
              f"train (a): REPRO_USE_FLASH=1 under grad did not raise ({raised})")
        out["a"]["flash_forced_raises"] = raised

        # ---- (b) timed steps ----------------------------------------------- #
        state, _ = step1(state, batches[1])  # warm
        sync()
        t0 = time.perf_counter()
        for i in range(scale["timed_steps"]):
            state, metrics = step1(state, batches[2 + i])
        sync()
        step_s = (time.perf_counter() - t0) / scale["timed_steps"]
        check(np.isfinite(float(metrics["loss"])), "train (b): the loss is not finite")
        gemm_flop = 6 * matmul * tokens
        remat_flop = 2 * (matmul - cfg.d_model * cfg.vocab_size) * tokens
        attn_fwd = 4 * b * cfg.num_heads * s * s * cfg.head_dim * cfg.num_layers
        bound = dict(gemm_ms=(gemm_flop + remat_flop) / PEAK_BF16_OPS_PER_S * 1e3,
                     attention_f32_ms=4 * attn_fwd / PEAK_F32_OPS_PER_S * 1e3)
        out["b"] = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                        train_mfu=gemm_flop / step_s / PEAK_BF16_OPS_PER_S,
                        model_flop=gemm_flop, remat_flop=remat_flop, attention_flop=4 * attn_fwd,
                        bound=bound, loss=float(metrics["loss"]))
        # two windows of one step each; the second is reported (a window can
        # pay the tracer's start-up in its host wall time)
        k = 2 + scale["timed_steps"]
        box, windows = {}, []
        for i in (k, k + 1):
            def profiled(batch=batches[i]):
                box["state"], _ = step1(state, batch)

            windows.append(profile_window(profiled, device, top=10**6))
            state = box.pop("state")
        prof = windows[-1]
        if "top" in prof:
            prof["by_kind_ms"] = _kernel_groups(prof["top"])
            prof["top"] = prof["top"][:12]
        out["b"]["profile_step"] = prof
        out["b"]["profile_first_window_wall_ms"] = windows[0].get("wall_ms")
        k += 1
        if cuda:
            out["b"]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

        # ---- (c) the migration path: save, restore, the first step --------- #
        at = k + 1  # the state has taken this many steps
        tmp = tempfile.mkdtemp(prefix="repro_ckpt_")
        try:
            free = shutil.disk_usage(tmp).free
            want_bytes = sum(t.numel() * (4 if t.dtype == torch.bfloat16 else t.element_size())
                             for t in tree_leaves(state))
            log(f"[train] checkpoint into {tmp}: {free / 1e9:.1f} GB free, ~{want_bytes / 1e9:.2f} GB to write")
            check(free > 1.1 * want_bytes, f"train (c): {free} bytes free for a {want_bytes}-byte checkpoint")
            path = os.path.join(tmp, "ckpt.npz")
            sync()
            t0 = time.perf_counter()
            save_checkpoint(path, state, step=at, metadata={"arch": cfg.name})
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            fsync_s = time.perf_counter() - t0
            nbytes = os.path.getsize(path)
            fresh = init(1)
            t0 = time.perf_counter()
            fresh, got_at = restore_checkpoint(path, fresh)
            sync()
            restore_s = time.perf_counter() - t0
            check(got_at == at, f"train (c): restored step {got_at}, saved {at}")
            differ = [p for (p, x), (_, y) in zip(_leaf_paths(fresh), _leaf_paths(state))
                      if x.dtype != y.dtype or not torch.equal(x, y)]
            check(not differ, f"train (c): restored leaves differ from the saved state: {differ}")
            nxt = batches[at]
            state, m_go = step1(state, nxt)  # the uninterrupted run's next step
            loss_go = float(m_go["loss"])
            del state
            if cuda:
                torch.cuda.empty_cache()
            sync()
            t0 = time.perf_counter()
            fresh, m_back = step1(fresh, nxt)
            loss_back = float(m_back["loss"])
            first_s = time.perf_counter() - t0
            check(abs(loss_back - loss_go) <= 1e-6 * abs(loss_go),
                  f"train (c): the first step after the restore has loss {loss_back}, "
                  f"the uninterrupted run {loss_go}")
            total = save_s + restore_s + first_s
            out["c"] = dict(bytes=nbytes, save_s=save_s, save_gb_per_s=nbytes / save_s / 1e9,
                            fsync_s=fsync_s, restore_s=restore_s,
                            restore_gb_per_s=nbytes / restore_s / 1e9, first_step_s=first_s,
                            save_restore_first_step_s=total, loss_uninterrupted=loss_go,
                            loss_after_restore=loss_back, bitwise_loss=loss_back == loss_go,
                            free_gb=free / 1e9, simulator_overhead_s=dict(
                                MIGRATION_OVERHEAD_S, default=migration_overhead_s(cfg.name)))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del fresh
        if cuda:
            torch.cuda.empty_cache()
        check(fa.flash_attention.launches == launches0,
              f"train: the training path launched flash_attention "
              f"{fa.flash_attention.launches - launches0} times")

        # ---- (d) f32 train_loop, card against host ------------------------- #
        out["d"] = train_loop_check(device, scale["arch"], scale["f32"])
    finally:
        if saved_env is not None:
            os.environ["REPRO_USE_FLASH"] = saved_env
    if cuda:
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
    bb, c, d = out["b"], out["c"], out["d"]
    log(f"[train] {cfg.name} {out['reduced'] or 'full depth'}, B {b} x S {s}: step "
        f"{bb['step_ms']:.1f} ms, {bb['tokens_per_s']:.0f} tokens/s, train_mfu "
        f"{bb['train_mfu']:.4f}, peak {out.get('peak_memory_gb', 0):.1f} GB; checkpoint "
        f"{c['bytes'] / 1e9:.2f} GB: save {c['save_s']:.2f} s ({c['save_gb_per_s']:.2f} GB/s), "
        f"restore {c['restore_s']:.2f} s ({c['restore_gb_per_s']:.2f} GB/s), first step "
        f"{c['first_step_s']:.3f} s; f32 {device.type} vs host: losses {d['loss_max_rel_err']:.3g}, "
        f"params {d['params_rel_l2']:.3g} (worst leaf {d['worst_leaf']} {d['worst_leaf_rel_l2']:.3g})")
    log("[train] " + json.dumps(out))
    return out


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _leaf_paths(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rel_l2(got, want):
    scale = float(want.double().norm())
    return float((got.double() - want.double()).norm()) / (scale if scale > 0 else 1.0)


# --------------------------------------------------------------------------- #
# phase 8: the dry-run
# --------------------------------------------------------------------------- #
def dryrun_case(arch, shape, multi_pod=False):
    """One run of the dry-run's command line on the host (``arch`` may be
    ``all``), in a subprocess that sees no card (``CUDA_VISIBLE_DEVICES``
    empty) and runs on one thread: its arguments, exit code, report lines,
    stderr's tail and seconds."""
    args = ["--arch", arch, "--shape", shape] + (["--multi-pod"] if multi_pod else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    reports = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    return dict(args=args, rc=res.returncode, reports=reports, err=res.stderr[-1500:],
                s=time.perf_counter() - t0)


def dryrun_row(device, scale):
    """(b): tie the dry-run's count to the program the card runs.  Row (e)'s
    prefill of B 1 x ``prefill_s`` tokens and its decode step at B
    ``batch`` on a ``context``-slot cache (at its last position, as the
    dry-run steps it), counted on abstract tensors on the 1x1 mesh
    (``dryrun.count_step``); then the same prefill and step on ``device``
    on the row's weights (seed 0) with ``REPRO_USE_FLASH=0``, the dry-run's
    einsum path, under ``torch.utils.flop_counter.FlopCounterMode``.  The
    FLOPs must be equal exactly, and the dry-run's state bytes those of the
    row's params (prefill) and params and cache (decode) on ``device``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.specs import InputShape, tree_paths_and_tensors
    from repro_torch.models import get_model

    cfg = (get_reduced if scale["reduced"] else get_config)(scale["arch"])
    s, b, ctx = scale["prefill_s"], scale["batch"], scale["context"]
    shapes = dict(prefill=InputShape("row_prefill", s, 1, "prefill"),
                  decode=InputShape("row_decode", ctx, b, "decode"))
    counted = {k: dryrun.count_step(cfg, shape, make_smoke_mesh()) for k, shape in shapes.items()}

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for _, ts in tree_paths_and_tensors(tree) for t in ts)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    model = get_model(cfg)
    out = dict(model=cfg.name, layers=cfg.num_layers, prefill_tokens=s, batch=b, context=ctx)
    saved = os.environ.get("REPRO_USE_FLASH")
    os.environ["REPRO_USE_FLASH"] = "0"
    try:
        params = model.init(torch.Generator(device=device).manual_seed(0), cfg)
        gen = torch.Generator(device=device).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=device)
        sync()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            logits, _ = model.forward(params, cfg, {"tokens": tokens})
        sync()
        out["prefill"] = dict(card_flops=fc.get_total_flops(), card_s=time.perf_counter() - t0,
                              card_state_bytes=nbytes(params))
        check(bool(torch.isfinite(logits).all()), "(b): the einsum prefill's logits are not finite")
        del logits
        cache = model.init_cache(cfg, b, ctx, device)
        step_tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=device)
        sync()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            logits, _ = model.decode_step(params, cfg, {"tokens": step_tokens}, cache, ctx - 1)
        sync()
        out["decode"] = dict(card_flops=fc.get_total_flops(), card_s=time.perf_counter() - t0,
                             card_state_bytes=nbytes(params) + nbytes(cache))
        check(bool(torch.isfinite(logits).all()), "(b): the decode step's logits are not finite")
        del params, cache, logits
    finally:
        if saved is None:
            os.environ.pop("REPRO_USE_FLASH", None)
        else:
            os.environ["REPRO_USE_FLASH"] = saved
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for kind, c in counted.items():
        row = out[kind]
        row.update(flops=c.flops, bytes=c.bytes, state_bytes=c.state_bytes_per_device,
                   count_s=c.seconds, compute_term_ms=c.flops / PEAK_BF16_OPS_PER_S * 1e3,
                   memory_term_ms=c.bytes / PEAK_BYTES_PER_S * 1e3)
        check(row["flops"] == row["card_flops"],
              f"(b) {kind}: the dry-run counts {row['flops']} FLOPs, the card's run {row['card_flops']}")
        check(row["state_bytes"] == row["card_state_bytes"],
              f"(b) {kind}: the dry-run's state is {row['state_bytes']} bytes, the card's "
              f"{row['card_state_bytes']}")
    return out


def dryrun_phase(device, scale, serve_row_e):
    """Phase 8.  (a) the dry-run's command line, ``scale["cases"]`` (every
    arch at prefill_32k and decode_32k on the single-pod mesh, train_4k
    where it fits, one multi-pod case), ``scale["workers"]`` subprocesses at
    a time on the host while (b) runs: each must exit 0 with a well-formed
    report per combination (chips 256 or 512, mesh 16x16 or 2x16x16, FLOPs
    per device > 0, no collective term); (b) :func:`dryrun_row`.  The counted FLOPs are
    printed beside ``dense_row_bounds``' ``prefill_ops`` (it counts the
    causal half of S x S; the einsum path computes all of it), and the
    dry-run's compute and memory terms at the 1x1 mesh beside row (e)'s
    measured prefill and step (``serve_row_e``); no gate on those ratios."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_config, get_reduced, list_archs

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=scale["workers"]) as pool:
        futures = [pool.submit(dryrun_case, *case) for case in scale["cases"]]
        t1 = time.perf_counter()
        row = dryrun_row(device, scale["row"])
        row["s"] = time.perf_counter() - t1
        results = [f.result() for f in futures]
    out = dict(cases=[], row=row)
    for r in results:
        multi, what = "--multi-pod" in r["args"], " ".join(r["args"])
        check(r["rc"] == 0, f"(a) dry-run {what}: exit {r['rc']}: {r['err']}")
        want = len(list_archs()) if r["args"][1] == "all" else 1
        check(len(r["reports"]) == want, f"(a) dry-run {what}: {len(r['reports'])} reports, wanted {want}")
        log(f"[dryrun] (a) {what}: {want} report(s) in {r['s']:.2f} s")
        for d in r["reports"]:
            check(d["chips"] == (512 if multi else 256) and d["mesh"] == ("2x16x16" if multi else "16x16")
                  and d["hlo_flops_per_device"] > 0 and d["collective_bytes_per_device"] == 0
                  and d["bottleneck"] in ("compute", "memory"),
                  f"(a) dry-run {what}: malformed report {d}")
            out["cases"].append({k: d[k] for k in (
                "arch", "shape", "mesh", "hlo_flops_per_device", "hlo_bytes_per_device",
                "compute_term_s", "memory_term_s", "collective_term_s", "bottleneck",
                "model_flops_ratio", "state_bytes_per_device", "compile_s")})
            log(f"[dryrun] (a) {d['arch']} x {d['shape']} on {d['mesh']}: compute "
                f"{d['compute_term_s']:.6g} s, memory {d['memory_term_s']:.6g} s, collective "
                f"{d['collective_term_s']:.6g} s ({d['bottleneck']}); state "
                f"{d['state_bytes_per_device']} B per device; counted in {d['compile_s']:.2f} s")
    out["a_s"] = max(r["s"] for r in results)

    cfg = (get_reduced if scale["row"]["reduced"] else get_config)(scale["row"]["arch"])
    bounds = dense_row_bounds(cfg, scale["row"]["prefill_s"], scale["row"]["batch"], 63)
    pre, dec = row["prefill"], row["decode"]
    row["prefill_ops_bound"] = bounds["prefill_ops"]
    log(f"[dryrun] (b) {row['model']} prefill B 1 x S {row['prefill_tokens']}: {pre['flops']} FLOPs "
        f"counted = {pre['card_flops']} on {device.type} (einsum path, {pre['card_s']:.3f} s under "
        f"FlopCounterMode); dense_row_bounds' prefill_ops {bounds['prefill_ops']} "
        f"(counted / it {pre['flops'] / bounds['prefill_ops']:.4f}); state {pre['state_bytes']} B = "
        f"the params on {device.type}; terms at the 1x1 mesh: compute {pre['compute_term_ms']:.3f} ms, "
        f"memory {pre['memory_term_ms']:.3f} ms")
    log(f"[dryrun] (b) decode step B {row['batch']} on {row['context']} slots: {dec['flops']} FLOPs "
        f"counted = {dec['card_flops']} on {device.type}; state {dec['state_bytes']} B = params + cache; "
        f"terms: compute {dec['compute_term_ms']:.4f} ms, memory {dec['memory_term_ms']:.3f} ms")
    if serve_row_e:  # row (e)'s measured prefill (K6) and step, phase 5
        row["measured_prefill_s"], row["measured_step_ms"] = serve_row_e["prefill_s"], serve_row_e["step_ms"]
        log(f"[dryrun] (b) row (e) measured: prefill {serve_row_e['prefill_s'] * 1e3:.1f} ms "
            f"(÷ compute term {serve_row_e['prefill_s'] * 1e3 / pre['compute_term_ms']:.2f}, "
            f"÷ memory term {serve_row_e['prefill_s'] * 1e3 / pre['memory_term_ms']:.2f}); step "
            f"{serve_row_e['step_ms']:.1f} ms (÷ compute term "
            f"{serve_row_e['step_ms'] / dec['compute_term_ms']:.1f}, ÷ memory term "
            f"{serve_row_e['step_ms'] / dec['memory_term_ms']:.2f})")
    out["s"] = time.perf_counter() - t0
    log(f"[dryrun] phase 8: {len(results)} command lines, {len(out['cases'])} reports (the longest "
        f"{out['a_s']:.1f} s, {scale['workers']} at a time) beside row (b) ({row['s']:.1f} s) in "
        f"{out['s']:.1f} s")
    log("[dryrun] " + json.dumps(out))
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


#: what ``ptxas`` says when it undoes the bf16 K6 design: ``setmaxnreg``
#: ignored (C7508) or wgmma serialised (C7512, e.g. "insufficient register
#: resources"); either in the flash_attention compiler log fails phase 1
K6_PTXAS_FAULTS = ("C7508", "C7512")


def build_report():
    """Phase 1's record of what was built: ``ptxas``'s registers, static
    shared memory and spills for every attention kernel instance (every K6
    instance, bf16 and f32, the D = 80 instances and K7's tensor-core
    instances must not spill), the flash_attention compiler log free of
    ``K6_PTXAS_FAULTS``, in the SASS of each bf16 K6 instance its ``HGMMA``
    instructions (it must be a tensor-core kernel) and the two
    ``USETMAXREG`` of its register hand-off (none is a failure), in the
    SASS of each bf16 K7 instance (``mma::flash_decode_partial_mma<D>``,
    every head dim) its ``HMMA`` instructions (none is a failure), and in the
    SASS of each f32 K6 instance its ``FFMA`` count and no ``HMMA`` or
    ``HGMMA`` (its products must stay exact f32), and the same of every K7
    f32 instance (``ffma::flash_decode_partial_ffma<D, GP>``, 23: no spill,
    ``FFMA``s, no ``HMMA`` or ``HGMMA`` in the flash_decode library's
    SASS)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.kernels.flash_decode import FFMA_HEAD_CLASSES, ffma_max_group

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
    faults = [line.strip() for line in build.compiler_log("flash_attention").splitlines()
              if any(code in line for code in K6_PTXAS_FAULTS)]
    check(not faults, f"ptxas undid the bf16 flash_attention design: {faults}")
    d80 = {fn: r for fn, r in ptxas.items() if "Li80E" in fn}  # zamba2's head dim
    check(d80 and all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 for r in d80.values()),
          f"the D = 80 attention instances spill (or were not built): {d80}")
    k6 = [(f"flash_attention_wgmmaILi{d}E", f"K6's bf16 D = {d} instance") for d in HEAD_DIMS]
    k6 += [(f"flash_attention_ffmaILi{d}E", f"K6's f32 D = {d} instance") for d in HEAD_DIMS]
    k7 = [(f"flash_decode_partial_mmaILi{d}E", f"K7's tensor-core D = {d} instance") for d in HEAD_DIMS]
    k7 += [(f"flash_decode_partial_ffmaILi{d}E", f"K7's f32 D = {d} instances") for d in HEAD_DIMS]
    for sym, what in k6 + k7:
        inst = {fn: r for fn, r in ptxas.items() if sym in fn}
        check(inst and all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                           for r in inst.values()), f"{what} spills (or was not built): {inst}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[build] cuobjdump not found: the SASS of the bf16 flash_attention instances was NOT checked")
        return dict(ptxas=ptxas, hgmma=None, setmaxnreg=None, ffma=None, k7_ffma=None, k7_hmma=None)
    sass = "".join(subprocess.run([tool, "-sass", str(build._target(name))], capture_output=True,
                                  text=True, check=True, timeout=300).stdout
                   for name in ("flash_attention", "flash_decode"))
    hgmma, setmaxnreg, ffma, k7_ffma, k7_hmma, fn = {}, {}, {}, {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if "flash_attention_wgmma" in fn:
                hgmma[fn] = setmaxnreg[fn] = 0
            elif "flash_attention_ffma" in fn:
                ffma[fn] = dict(FFMA=0, HMMA=0, HGMMA=0)
            elif "flash_decode_partial_ffma" in fn:
                k7_ffma[fn] = dict(FFMA=0, HMMA=0, HGMMA=0)
            elif "flash_decode_partial_mma" in fn:
                k7_hmma[fn] = 0
        elif fn in hgmma:
            hgmma[fn] += "HGMMA" in line
            setmaxnreg[fn] += "USETMAXREG" in line
        elif fn in k7_hmma:
            k7_hmma[fn] += " HMMA" in line
        elif fn in ffma or fn in k7_ffma:
            counts = ffma.get(fn) or k7_ffma[fn]
            for op in counts:
                counts[op] += f" {op}" in line
    log(f"[build] HGMMA instructions per bf16 flash_attention instance: {json.dumps(hgmma)}")
    log(f"[build] USETMAXREG per bf16 flash_attention instance: {json.dumps(setmaxnreg)}")
    log(f"[build] FFMA / HMMA / HGMMA per f32 flash_attention instance: {json.dumps(ffma)}")
    check(len(hgmma) == len(HEAD_DIMS) and all(n > 0 for n in hgmma.values()),
          f"the bf16 flash_attention instances hold no HGMMA instruction: {hgmma}")
    check(all(n >= 2 for n in setmaxnreg.values()),
          f"a bf16 flash_attention instance lost its setmaxnreg hand-off: {setmaxnreg}")
    check(len(ffma) == len(HEAD_DIMS) and all(
        c["FFMA"] > 0 and c["HMMA"] == 0 and c["HGMMA"] == 0 for c in ffma.values()),
        f"an f32 flash_attention instance is not an exact f32 FFMA kernel: {ffma}")
    log(f"[build] HMMA instructions per bf16 flash_decode instance: {json.dumps(k7_hmma)}")
    check(len(k7_hmma) == len(HEAD_DIMS) and all(n > 0 for n in k7_hmma.values()),
          f"a bf16 flash_decode instance holds no HMMA instruction: {k7_hmma}")
    log(f"[build] FFMA / HMMA / HGMMA per f32 flash_decode instance: {json.dumps(k7_ffma)}")
    n_k7 = sum(c <= ffma_max_group(d) for d in HEAD_DIMS for c in FFMA_HEAD_CLASSES)
    check(len(k7_ffma) == n_k7 and all(
        c["FFMA"] > 0 and c["HMMA"] == 0 and c["HGMMA"] == 0 for c in k7_ffma.values()),
        f"an f32 flash_decode instance is not an exact f32 FFMA kernel: {k7_ffma}")
    return dict(ptxas=ptxas, hgmma=hgmma, setmaxnreg=setmaxnreg, ffma=ffma, k7_ffma=k7_ffma,
                k7_hmma=k7_hmma)


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
    built = dict(ptxas={}, hgmma=None, setmaxnreg=None, ffma=None, k7_ffma=None, k7_hmma=None)

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
    floor_ms = launch_floor_ms(device)
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
    # rows added later draw from their own generator, so the rows above keep
    # the inputs (and the auction rows the round counts) of earlier runs
    gen_late = torch.Generator().manual_seed(18)
    wide = scale.get("bid_wide", 64)
    lap_rows["wide"] = compare_lap_bid((1, wide, wide), device, gen_late)
    fused_rows["wide"] = compare_lap_bid_fused((1, wide, wide), device, gen_late, tb="zero")
    mig_small = compare_migration_cost(48, device, gen_late)  # (g)'s 48 GPUs
    k6_rows = [compare_flash_attention(shape, device, seed=10 + i, long=shape[1] > 8192)
               for i, shape in enumerate(serve["k6_shapes"])]
    k6_rows += [compare_flash_attention(shape, device, seed=30 + i, dtype="float32")
                for i, shape in enumerate(serve.get("k6_f32_shapes", []))]
    k7_rows = [compare_flash_decode(shape, device, seed=20 + i, ptxas=built["ptxas"])
               for i, shape in enumerate(serve["k7_shapes"])]
    k7_rows += [compare_flash_decode(shape, device, seed=40 + i, ptxas=built["ptxas"], dtype="float32")
                for i, shape in enumerate(serve.get("k7_f32_shapes", []))]
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

    # ---- phase 5: serving llama3-8b (e, f), then the MoE and MLA families, -- #
    # then the SSM and the hybrid, the encoder-decoder and the other dense configs
    serve_paths, serve_rows = {}, {}  # path -> its launches, its row
    later_rows = (scale.get("serve_moe", SERVE_MOE_REHEARSAL) + scale.get("serve_ssm", SERVE_SSM_REHEARSAL)
                  + scale.get("serve_encdec", SERVE_ENCDEC_REHEARSAL)
                  + (scale.get("serve_dense") or serve_dense_rehearsal()))
    for path, row_scale in [("serve", serve)] + [("serve_" + r["arch"], r) for r in later_rows]:
        zero_counts()
        t0 = time.perf_counter()
        row, expect = serve_row(device, row_scale)
        got = read_counts()
        log(f"[{path} path] {time.perf_counter() - t0:.3f} s; launches {json.dumps(got)} (K6 in f32: "
            f"{row.get('k6_f32_launches', 0)})")
        if device.type == "cuda":
            want = dict.fromkeys(counted, 0)
            want.update(expect)
            check(got == want, f"the {path} path launched {got}, wanted {want}")
            if row["attention"] == "flash (K6)":
                check(got["flash_attention"] > 0 and got["flash_decode"] == 1,
                      f"the {path} path launched {got}: K6 and K7 must have run")
        serve_paths[path], serve_rows[path] = got, row
    # (e5)'s, (e6)'s and (e7)'s K7 is the tensor-core instance at D 80, 64
    # (group 1) and 192 (group 12)
    for path, d, g in (("serve_zamba2-2.7b", 80, 1), ("serve_seamless-m4t-medium", 64, 1),
                       ("serve_nemotron-4-340b", 192, 12)):
        row = serve_rows.get(path)
        if device.type != "cuda" or not row:
            continue
        inst = sorted(fn for fn in built["ptxas"] if f"flash_decode_partial_mmaILi{d}E" in fn)
        log(f"[serve] {path} K7 plan {json.dumps(row['k7_plan'])}; instance {inst}")
        check(row["k7_plan"]["instance"] == "mma_bf16" and row["k7_plan"]["heads_per_warp"] == g
              and inst, f"{path}: K7's mma::<{d}> instance was not built or not chosen: "
              f"{row['k7_plan']}, {inst}")

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

    # ---- phase 7: training llama3-8b --------------------------------------- #
    zero_counts()
    t0 = time.perf_counter()
    train_phase(device, scale.get("train", TRAIN_REHEARSAL))
    train_launches = read_counts()
    log(f"[train path] {time.perf_counter() - t0:.3f} s; launches {json.dumps(train_launches)}")
    check(not any(train_launches.values()), f"the training path launched a kernel: {train_launches}")

    # ---- phase 8: the dry-run ---------------------------------------------- #
    zero_counts()
    dryrun_phase(device, scale.get("dryrun", DRYRUN_REHEARSAL), serve_rows.get("serve"))
    dryrun_launches = read_counts()
    check(not any(dryrun_launches.values()), f"the dry-run phase launched a kernel: {dryrun_launches}")

    by_path = {name: {"round": launches[name], "fused": fused_launches[name],
                      "evaluate": eval_launches[name], "scalability": scal_launches[name],
                      "train": train_launches[name], "dryrun": dryrun_launches[name]}
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
    shape_keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound", "library_ms",
                  "row_max_ms", "max_abs_err", "l2_ms", "hbm_sets")
    for name, rows, source, replaces in (
        ("lap_bid_batched", [lap_rows[k] for k in ("fanout", "node", "wide")],
         "src/repro_torch/kernels/csrc/lap_bid.cu", "src/repro/kernels/lap_bid.py:149"),
        ("migration_cost", [mig_row, mig_small], "src/repro_torch/kernels/csrc/migration_cost.cu",
         "src/repro/kernels/migration_cost.py:51"),
        ("lap_bid_fused_batched", [fused_rows[k] for k in ("fanout", "node", "wide")],
         "src/repro_torch/kernels/csrc/lap_bid.cu", "src/repro/kernels/lap_bid.py:343"),
    ):
        row = rows[0]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path[name].values()), launches_by_path=by_path[name],
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"], share_of_bound=row["share_of_bound"],
            l2_ms=row["l2_ms"], hbm_sets=row["hbm_sets"], launch_floor_ms=floor_ms,
            other_shapes=[{key: r.get(key) for key in shape_keys} for r in rows[1:]],
        ))
    kernels[-1]["also_replaces"] = ["src/repro/kernels/lap_bid.py:283"]
    for k in kernels:  # the bid-only kernels: the loop that called them is lap_auction now
        if k["name"].startswith("lap_bid"):
            k["main_path_route"] = "lap_auction"
    for name, rows, source, replaces, extra in (
        ("flash_attention", k6_rows, "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:89", ()),
        ("flash_decode", k7_rows, "src/repro_torch/kernels/csrc/flash_decode.cu",
         "src/repro/kernels/flash_decode.py:86",
         ("instance", "chunks", "splits", "blocks", "blocks_per_sm")),
    ):
        row = rows[0]  # the serving path's shape
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=(sum(n[name] for n in serve_paths.values()) + train_launches[name]
                      + dryrun_launches[name]),
            launches_by_path={**{path: n[name] for path, n in serve_paths.items()},
                              "train": train_launches[name], "dryrun": dryrun_launches[name]},
            **({"f32_launches_by_path": {path: r.get("k6_f32_launches", 0)
                                         for path, r in serve_rows.items()}}
               if name == "flash_attention" else {}),
            max_abs_err=row["max_abs_err"], rel_err=row["rel_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"], share_of_bound=row["share_of_bound"],
            x_library=row["x_library"],
            other_shapes=[{key: r[key] for key in ("shape", "dtype", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms", "max_abs_err", "rel_err",
                                                   "share_of_bound", "x_library") + extra}
                          for r in rows[1:]],
        ))
        if device.type == "cuda":
            kernels[-1]["instances"] = {fn: r for fn, r in built["ptxas"].items() if name in fn}
            if name == "flash_attention":
                kernels[-1]["hgmma"] = built["hgmma"]
                kernels[-1]["setmaxnreg"] = built["setmaxnreg"]
                kernels[-1]["ffma"] = built["ffma"]
            else:
                kernels[-1]["hmma"] = built["k7_hmma"]
                kernels[-1]["ffma"] = built["k7_ffma"]
    next(k for k in kernels if k["name"] == "flash_attention")["head_dim_routing"] = routing_row
    return kernels


def main() -> int:
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    if not src.is_dir():
        print(f"chip_smoke: {src} is missing; run from a checkout of the repo", file=sys.stderr)
        return 2
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
