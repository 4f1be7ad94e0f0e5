"""Gavel (OSDI'20) and POP (SOSP'21) optimisation-based baselines.

Gavel folds scheduling + placement + packing into one linear program; POP
partitions that LP into k independent sub-problems to claw back
scalability.  We implement the single-GPU-type LAS variant with
space-sharing, which is what Figs. 2/11/14 compare against:

  max  sum_j w_j * ( tput_j * x_j + sum_k ctput_{jk} * x_{jk} )
  s.t. x_j + sum_k x_{jk} <= 1                 (per-job time fraction)
       sum_j g_j x_j + sum_{j<k} g_j x_{jk} <= G   (capacity; a packed pair
                                                    shares one set of GPUs)
       x >= 0

with w_j = 1 / (attained service + eps) (LAS weighting) and pair variables
x_{jk} only for equal-GPU-count packable pairs — the O(n^2) variable count
that causes the scalability cliff of Fig. 2.

The LP solution doubles as a *priority score* (Gavel's round-based
mechanism): priority_j = target allocation / (received allocation + eps),
which `GavelPolicy.sort_key` feeds to the round executor.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.jobs import JobState
from repro_torch.core.policies.base import SchedulingPolicy
from repro_torch.core.profiler import ThroughputProfile


@dataclasses.dataclass
class LpSolution:
    #: job_id -> solo time fraction
    solo: Dict[int, float]
    #: (job_id_a, job_id_b) -> packed time fraction
    pairs: Dict[Tuple[int, int], float]
    objective: float
    wall_time_s: float
    num_variables: int


def solve_gavel_lp(
    jobs: Sequence[JobState],
    profile: ThroughputProfile,
    cluster: ClusterSpec,
    packing: bool = True,
    max_pairs: int | None = None,
) -> LpSolution:
    """Build and solve the Gavel LP with scipy's HiGHS backend."""
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    t0 = time.perf_counter()
    n = len(jobs)
    # pair variables: equal gpu count, both packable, j < k
    pair_idx: List[Tuple[int, int]] = []
    if packing:
        by_gpus: Dict[int, List[int]] = {}
        for i, j in enumerate(jobs):
            if j.spec.packable:
                by_gpus.setdefault(j.num_gpus, []).append(i)
        for group in by_gpus.values():
            for a_pos, i in enumerate(group):
                for k in group[a_pos + 1 :]:
                    pair_idx.append((i, k))
                    if max_pairs is not None and len(pair_idx) >= max_pairs:
                        break
                if max_pairs is not None and len(pair_idx) >= max_pairs:
                    break
            if max_pairs is not None and len(pair_idx) >= max_pairs:
                break
    p = len(pair_idx)
    nv = n + p

    w = np.array(
        [1.0 / (j.attained_service + 3600.0) for j in jobs]
    )  # LAS weight
    tput = np.array(
        [
            profile.isolated(j.spec.model, j.num_gpus, j.strategy)
            for j in jobs
        ]
    )
    c = np.zeros(nv)
    c[:n] = -(w * tput)  # linprog minimises
    for v, (i, k) in enumerate(pair_idx):
        a, b = jobs[i], jobs[k]
        na, nb = profile.normalized_packed(a.spec.model, b.spec.model)
        ctput = na * tput[i] + nb * tput[k]
        c[n + v] = -(0.5 * (w[i] + w[k]) * ctput)

    a_ub = lil_matrix((n + 1, nv))
    b_ub = np.ones(n + 1)
    for i in range(n):  # per-job time fraction
        a_ub[i, i] = 1.0
    for v, (i, k) in enumerate(pair_idx):
        a_ub[i, n + v] = 1.0
        a_ub[k, n + v] = 1.0
    # capacity row
    for i, j in enumerate(jobs):
        a_ub[n, i] = j.num_gpus
    for v, (i, k) in enumerate(pair_idx):
        a_ub[n, n + v] = jobs[i].num_gpus
    b_ub[n] = cluster.num_gpus

    res = linprog(
        c,
        A_ub=a_ub.tocsr(),
        b_ub=b_ub,
        bounds=(0, 1),
        method="highs",
    )
    x = res.x if res.x is not None else np.zeros(nv)
    solo = {jobs[i].job_id: float(x[i]) for i in range(n)}
    pairs = {
        (jobs[i].job_id, jobs[k].job_id): float(x[n + v])
        for v, (i, k) in enumerate(pair_idx)
        if x[n + v] > 1e-6
    }
    return LpSolution(
        solo, pairs, -float(res.fun or 0.0), time.perf_counter() - t0, nv
    )


class GavelPolicy(SchedulingPolicy):
    """Priority order derived from the LP allocation targets.

    The simulator refreshes ``self.solution`` once per round (that solve IS
    Gavel's decision-making overhead, Fig. 2); between solves the sort key
    is (received - target), smaller (more starved) first.
    """

    name = "gavel"
    packing_in_lp = True

    def __init__(self, profile=None, cluster: ClusterSpec | None = None):
        super().__init__(profile)
        self.cluster = cluster
        self.solution: LpSolution | None = None
        self._received: Dict[int, float] = {}

    def refresh(self, jobs: Sequence[JobState], cluster: ClusterSpec) -> float:
        self.solution = solve_gavel_lp(
            jobs, self.profile, cluster, packing=self.packing_in_lp
        )
        return self.solution.wall_time_s

    def note_round(self, ran_job_ids) -> None:
        for j in ran_job_ids:
            self._received[j] = self._received.get(j, 0.0) + 1.0

    def sort_key(self, job: JobState, now: float, cluster: ClusterSpec):
        target = 0.0
        if self.solution is not None:
            target = self.solution.solo.get(job.job_id, 0.0)
            for (a, b), frac in self.solution.pairs.items():
                if job.job_id in (a, b):
                    target += frac
        received = self._received.get(job.job_id, 0.0)
        rounds = max(sum(self._received.values()), 1.0)
        return received / rounds - target  # most starved (neg) first


class PopPolicy(GavelPolicy):
    """POP: partition the Gavel LP into ceil(n / partition_size) pieces,
    each owning an equal slice of the cluster, and solve independently."""

    name = "pop"

    def __init__(self, profile=None, cluster=None, partition_size: int = 256):
        super().__init__(profile, cluster)
        self.partition_size = partition_size

    def refresh(self, jobs: Sequence[JobState], cluster: ClusterSpec) -> float:
        n = len(jobs)
        k = max(1, int(np.ceil(n / self.partition_size)))
        rng = np.random.default_rng(0)
        perm = rng.permutation(n)
        total_t = 0.0
        solo: Dict[int, float] = {}
        pairs: Dict[Tuple[int, int], float] = {}
        sub_cluster = ClusterSpec(
            max(1, cluster.num_nodes // k), cluster.gpus_per_node, cluster.gpu_type
        )
        nvars = 0
        for part in range(k):
            sel = [jobs[i] for i in perm[part::k]]
            if not sel:
                continue
            sol = solve_gavel_lp(sel, self.profile, sub_cluster, packing=True)
            total_t += sol.wall_time_s
            solo.update(sol.solo)
            pairs.update(sol.pairs)
            nvars += sol.num_variables
        self.solution = LpSolution(solo, pairs, 0.0, total_t, nvars)
        return total_t
