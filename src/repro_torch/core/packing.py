"""Packing as maximum-weight bipartite matching (§4.2, Algorithm 4).

Build G = (V1, V2, E): V1 = placed_jobs, V2 = pending_jobs, an edge (u, v)
iff the two jobs request the same number of GPUs (so v can overlay u's
GPUs), weight = profiled combined normalised throughput — maximised over
job u's parallelism-strategy candidates when enabled (Fig. 7b).

Solving the matching (Hungarian / auction) yields at most one pending job
per placed job, maximising total cluster throughput.  Jobs flagged
non-packable (strict deadline / priority, §4.3 "Fairness") get no edges.

Implementation note: we embed the bipartite graph in a rectangular benefit
matrix with 0 for missing edges; a zero-weight "match" is interpreted as
*no packing* (packing with combined weight 0 is never beneficial since any
positive weight adds throughput for a job that would otherwise idle in the
queue).  The matrix is typically very skew (|placed| >> |pending| on a
busy cluster); the engine's rectangular path solves it without the
``max(n, m)^2`` square embedding, and a :class:`MatchContext` carried by
the scheduler warm-starts / memoises consecutive rounds whose graph barely
changed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.jobs import JobState
from repro_torch.core.matching import MatchContext, solve_lap_batched
from repro_torch.core.profiler import ThroughputProfile


@dataclasses.dataclass
class PackingResult:
    #: pending job id -> placed job id
    matches: Dict[int, int]
    #: placed job id -> chosen parallelism strategy (LLM jobs whose strategy
    #: the matcher re-optimised to lift the edge weight)
    strategies: Dict[int, str]
    total_weight: float
    wall_time_s: float
    num_edges: int


def build_packing_graph(
    placed: Sequence[JobState],
    pending: Sequence[JobState],
    profile: ThroughputProfile,
    optimize_strategy: bool = True,
    packed_ok=None,
    placed_gpu_types: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Benefit matrix (|placed| x |pending|), fully vectorised.

    The per-MODEL-pair weight is memoised in the profile; the per-JOB-pair
    matrix is assembled with numpy indexing (the O(n^2) loop in pure Python
    was the scalability bottleneck — see EXPERIMENTS.md §Perf, scheduler
    iteration 1).

    ``placed_gpu_types`` (heterogeneous clusters) gives the GPU type of
    the node each PLACED job occupies; the edge weight — including memory
    feasibility, the thing that actually flips on 16 GB parts — is then
    profiled per type via :meth:`ThroughputProfile.for_gpu_type`.  ``None``
    (the default, and every homogeneous caller) is the seed path."""
    p, q = len(placed), len(pending)
    if p == 0 or q == 0:
        return np.zeros((p, q), dtype=np.float64)

    models = sorted({u.spec.model for u in placed} | {v.spec.model for v in pending})
    midx = {m: i for i, m in enumerate(models)}
    n_m = len(models)
    if placed_gpu_types is None:
        pairw = np.zeros((n_m, n_m), dtype=np.float64)
        for a in models:
            for b in models:
                pairw[midx[a], midx[b]] = profile.combined_weight(
                    a, b, optimize_strategy=optimize_strategy
                )[0]
        mp = np.array([midx[u.spec.model] for u in placed])
    else:
        # one weight table per GPU type present among the placed jobs; the
        # placed row then indexes (its node's type, its model)
        types = sorted(set(placed_gpu_types))
        tidx = {t: k for k, t in enumerate(types)}
        pairw = np.zeros((len(types), n_m, n_m), dtype=np.float64)
        for t in types:
            prof_t = profile.for_gpu_type(t)
            for a in models:
                for b in models:
                    pairw[tidx[t], midx[a], midx[b]] = prof_t.combined_weight(
                        a, b, optimize_strategy=optimize_strategy
                    )[0]
        mp = np.array(
            [
                tidx[t] * n_m + midx[u.spec.model]
                for u, t in zip(placed, placed_gpu_types)
            ]
        )
        pairw = pairw.reshape(len(types) * n_m, n_m)
    mq = np.array([midx[v.spec.model] for v in pending])
    gi = np.array([u.num_gpus for u in placed])
    gj = np.array([v.num_gpus for v in pending])
    ok_p = np.array(
        [u.spec.packable and u.packed_with is None for u in placed], dtype=bool
    )
    ok_q = np.array([v.spec.packable for v in pending], dtype=bool)

    mask = (gi[:, None] == gj[None, :]) & ok_p[:, None] & ok_q[None, :]
    if packed_ok is not None:
        if getattr(packed_ok, "vectorized_on_gpus", False):
            mask &= packed_ok.gpu_mask(gi, gj)
        else:
            ii, jj = np.nonzero(mask)
            for i, j in zip(ii, jj):
                if not packed_ok(placed[i], pending[j]):
                    mask[i, j] = False
    return np.where(mask, pairw[mp[:, None], mq[None, :]], 0.0)


def pack_jobs(
    placed: Sequence[JobState],
    pending: Sequence[JobState],
    profile: ThroughputProfile,
    optimize_strategy: bool = True,
    backend: str = "auto",
    packed_ok=None,
    context: Optional[MatchContext] = None,
    placed_gpu_types: Optional[Sequence[str]] = None,
    tie_break: bool = False,
) -> PackingResult:
    """Algorithm 4.

    ``backend`` is any matching-engine backend; the rectangular max-weight
    matching dispatches through
    :func:`repro_torch.core.matching.solve_lap_batched`, so the same config knob
    that batches migration LAPs also selects the packing solver
    (``auction`` is near-optimal within ``n*eps`` on these float
    throughput weights; the default ``auto`` stays exact).  ``context``
    threads the scheduler's :class:`MatchContext`, keyed by JOB identity:
    rows are placed job ids and columns are pending job ids, so a graph
    that gains/loses a job (the dominant round-to-round event under churn)
    re-assembles last round's auction prices for the surviving jobs
    instead of cold-starting the whole matrix, and an unchanged graph
    memo-hits outright.
    """
    t0 = time.perf_counter()
    if not placed or not pending:
        return PackingResult({}, {}, 0.0, time.perf_counter() - t0, 0)
    w = build_packing_graph(
        placed, pending, profile, optimize_strategy, packed_ok, placed_gpu_types
    )
    num_edges = int((w > 0).sum())
    if num_edges == 0:
        return PackingResult({}, {}, 0.0, time.perf_counter() - t0, 0)
    rows, cols = solve_lap_batched(
        w[None],
        maximize=True,
        backend=backend,
        context=context,
        context_key="packing",
        instance_ids=np.zeros(1, np.int64),
        row_ids=np.array([u.job_id for u in placed], np.int64),
        col_ids=np.array([v.job_id for v in pending], np.int64),
        tie_break=tie_break,
    ).pairs(0)
    matches: Dict[int, int] = {}
    strategies: Dict[int, str] = {}
    total = 0.0
    for i, j in zip(rows, cols):
        if w[i, j] <= 0.0:
            continue  # zero-weight assignment = leave unpacked
        u, v = placed[i], pending[j]
        matches[v.job_id] = u.job_id
        prof_u = (
            profile
            if placed_gpu_types is None
            else profile.for_gpu_type(placed_gpu_types[i])
        )
        _, s = prof_u.combined_weight(
            u.spec.model, v.spec.model, optimize_strategy=optimize_strategy
        )
        if s != "dp":
            strategies[u.job_id] = s
        total += w[i, j]
    return PackingResult(
        matches, strategies, float(total), time.perf_counter() - t0, num_edges
    )
