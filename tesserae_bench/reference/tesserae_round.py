"""Plain reference of one Tesserae round, in NumPy (and SciPy's exact
assignment solver), importing nothing of the program.

It judges what the timed path produced in a round, from the jobs the
benchmark generated and from the program's placement state:

* the Algorithm-3 cost matrix that K5 (``migration_cost``) returned,
  worked out again cell by cell;
* every node-pair LAP of the Algorithm-2 fan-out: the program's
  assignment must cost what the brute-force optimum costs;
* the relabelled plan: its true migration cost must equal the optimum of
  the node match over the fan-out's optima;
* the packing matching (Algorithm 4): its weight, under weights worked
  out again from the benchmark's frozen throughput model, against the
  max-weight matching, as a share of the auction's stated bound;
* the plan's feasibility (consolidated gangs, packing pairs on shared
  GPUs, the plan a node and GPU relabelling of the logical plan).

The costs are multiples of 1/16 and their sums are exact in f64, so the
first three comparisons are exact.  The reference follows the program
step by step from its state: the previous round's plan and the logical
plan that placement and packing produced are the program's; their
feasibility is checked here on their own.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from tesserae_bench import tput

EMPTY = -1


class Jobs:
    """The benchmark's jobs as arrays indexed by job id."""

    def __init__(self, jobs: Sequence):
        n = max(j.job_id for j in jobs) + 1
        self.gpus = np.zeros(n, np.int64)
        self.packable = np.zeros(n, bool)
        self.arrival = np.zeros(n)
        self.model = [""] * n
        for j in jobs:
            self.gpus[j.job_id] = j.num_gpus
            self.packable[j.job_id] = j.packable
            self.arrival[j.job_id] = j.arrival_s
            self.model[j.job_id] = j.model
        # 1 / (2 * gpus) per job id, and 0 at index -1 (an empty slot)
        self.weight = np.zeros(n + 1)
        self.weight[:n] = 1.0 / (2.0 * self.gpus)
        self._pair_w: Dict[tuple, float] = {}

    def pack_weight(self, a: str, b: str) -> float:
        key = (a, b)
        w = self._pair_w.get(key)
        if w is None:
            w = self._pair_w[key] = tput.combined_weight(a, b)
        return w


def restrict(slots: np.ndarray, keep: np.ndarray) -> np.ndarray:
    out = slots.copy()
    out[(out != EMPTY) & ~np.isin(out, keep)] = EMPTY
    return out


def job_ids(slots: np.ndarray) -> np.ndarray:
    return np.unique(slots[slots != EMPTY])


def cost_matrix(su: np.ndarray, sv: np.ndarray, weight: np.ndarray, block: int = 256) -> np.ndarray:
    """(U, V) Algorithm-3 costs of GPU rows ``su`` (U, P) and ``sv`` (V, P):
    the weights of the jobs in one row and not the other, summed."""
    wu, wv = weight[su], weight[sv]
    out = np.empty((su.shape[0], sv.shape[0]))
    for s in range(0, su.shape[0], block):
        a = su[s : s + block]
        eq = a[:, None, :, None] == sv[None, :, None, :]
        out_cost = (wu[s : s + block, None, :] * ~eq.any(axis=-1)).sum(axis=-1)
        in_cost = (wv[None, :, :] * ~eq.any(axis=-2)).sum(axis=-1)
        out[s : s + block] = out_cost + in_cost
    return out


def row_costs(su: np.ndarray, sv: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """Cost of GPU row i of ``su`` against row i of ``sv``, for every i."""
    eq = su[:, :, None] == sv[:, None, :]
    return (weight[su] * ~eq.any(axis=-1)).sum(axis=-1) + (weight[sv] * ~eq.any(axis=-2)).sum(axis=-1)


def pair_optima(pair_costs: np.ndarray, block: int = 16384) -> np.ndarray:
    """Least total of every (k, k) instance, by trying every permutation
    (k <= 6), else by SciPy per instance."""
    b, k, _ = pair_costs.shape
    if k > 6:
        return np.array([pair_costs[i][linear_sum_assignment(pair_costs[i])].sum() for i in range(b)])
    perms = np.array(list(itertools.permutations(range(k))))
    rows = np.arange(k)
    out = np.empty(b)
    for s in range(0, b, block):
        c = pair_costs[s : s + block]
        out[s : s + block] = c[:, rows[None, :], perms].sum(axis=-1).min(axis=1)
    return out


def assignment_costs(pair_costs: np.ndarray, col_of: np.ndarray):
    """Each instance's cost under the assignment ``col_of`` (B, k), and
    whether that assignment is a permutation."""
    b, k, _ = pair_costs.shape
    valid = (np.sort(col_of, axis=1) == np.arange(k)[None, :]).all(axis=1)
    cols = np.clip(col_of, 0, k - 1)
    cost = np.take_along_axis(pair_costs, cols[:, :, None], axis=2)[:, :, 0].sum(axis=1)
    return cost, valid


def _node_keys(slots: np.ndarray) -> np.ndarray:
    """(nodes, gpus) keys of each GPU's job set, sorted within each node:
    two nodes hold the same GPUs up to their order iff their rows match."""
    rows = np.sort(slots, axis=-1) + 1
    base = int(rows.max()) + 1
    key = np.zeros(rows.shape[:2], np.int64)
    for a in range(rows.shape[-1]):
        key = key * base + rows[..., a]
    return np.sort(key, axis=1)


def infeasibility(rec: Dict, jobs: Jobs, gpn: int, prev_phys: Optional[np.ndarray]) -> int:
    """How many of the plan's rules a round breaks (0 when feasible)."""
    bad = 0
    logical, phys, assign = rec["logical"], rec["phys"], rec["node_assignment"]
    kc = logical.shape[0]
    placed, pending, matches = rec["placed"], rec["pending"], rec["matches"]
    now = rec["now"]
    # the active set: arrived, placed or pending, never both
    both = np.intersect1d(placed, pending)
    bad += int(both.size > 0)
    act = np.concatenate([placed, pending]).astype(np.int64)
    bad += int(act.size and (act.max() >= jobs.gpus.size or (jobs.arrival[act] > now).any()))
    # the logical plan holds the placed jobs and the matched pending jobs
    in_plan = job_ids(logical)
    want = np.union1d(placed, np.fromiter(matches.keys(), np.int64, len(matches)))
    bad += int(not np.array_equal(in_plan, want))
    # each job on exactly its gang's GPUs, consolidated, at most once a GPU
    flat = logical.reshape(kc * gpn, -1)
    gpu_of = np.repeat(np.arange(kc * gpn), flat.shape[1])
    ids = flat.ravel()
    keep = ids != EMPTY
    ids, gpu_of = ids[keep], gpu_of[keep]
    count = np.bincount(ids, minlength=jobs.gpus.size)
    bad += int((count[in_plan] != jobs.gpus[in_plan]).any())
    pair = ids * (kc * gpn) + gpu_of
    bad += int(np.unique(pair).size != pair.size)
    nodes = np.bincount(np.unique(ids * kc + gpu_of // gpn) // kc, minlength=jobs.gpus.size)
    g = jobs.gpus[in_plan]
    bad += int((nodes[in_plan] != np.where(g <= gpn, 1, g // gpn)).any())
    # packing: a matched pending job shares exactly its placed partner's GPUs
    gpus_of: Dict[int, list] = {}
    for j, gid in sorted(zip(ids.tolist(), gpu_of.tolist())):
        gpus_of.setdefault(j, []).append(gid)
    placed_set = set(placed.tolist())
    partners = list(matches.values())
    bad += int(len(set(partners)) != len(partners))
    for p, q in matches.items():
        if (
            q not in placed_set
            or jobs.gpus[p] != jobs.gpus[q]
            or not (jobs.packable[p] and jobs.packable[q])
            or gpus_of.get(p) != gpus_of.get(q)
        ):
            bad += 1
            break
    # a GPU shared by two jobs holds a matched pair
    shared = (flat != EMPTY).all(axis=1)
    if shared.any():
        a, b = flat[shared, 0], flat[shared, 1]
        ok = np.array([matches.get(int(x)) == int(y) or matches.get(int(y)) == int(x) for x, y in zip(a, b)])
        bad += int(not ok.all())
    # the physical plan relabels the logical one node by node
    if np.array_equal(np.sort(assign), np.arange(kc)):
        bad += int(not np.array_equal(_node_keys(logical), _node_keys(phys[assign])))
    else:
        bad += 1
    # the state carried in is the previous round's plan, less finished jobs
    if prev_phys is not None:
        prev = rec["prev"]
        bad += int(((prev != EMPTY) & (prev != prev_phys)).any())
    return bad


def relabel_numbers(rec: Dict, jobs: Jobs, gpn: int) -> Dict[str, float]:
    """K5's cells off, fan-out instances off their optimum, and how far the
    plan's true relabel cost lies from the node match's optimum.

    Where the round holds no K5 matrix, ``k5_cells_off`` is not read; where
    it holds no fan-out assignments, the fan-out is judged on the node
    pairs the plan chose: each physical node's GPUs against the logical
    node relabelled onto it must cost that pair's optimum."""
    prev, logical, phys = rec["prev"], rec["logical"], rec["phys"]
    kc = logical.shape[0]
    common = np.intersect1d(job_ids(prev), job_ids(logical))
    pc = restrict(prev, common).reshape(kc * gpn, -1)
    lc = restrict(logical, common).reshape(kc * gpn, -1)
    c = cost_matrix(pc, lc, jobs.weight)
    out: Dict[str, float] = {}
    k5 = rec.get("k5")
    if k5 is not None:
        out["k5_cells_off"] = c.size if k5.shape != c.shape else int((k5 != c).sum())
    pairs = c.reshape(kc, gpn, kc, gpn).transpose(0, 2, 1, 3).reshape(kc * kc, gpn, gpn)
    opt = pair_optima(pairs)
    physc = restrict(phys, common).reshape(kc * gpn, -1)
    per_gpu = row_costs(pc, physc, jobs.weight)
    col_of = rec.get("pairs_col_of")
    if col_of is not None:
        cost, valid = assignment_costs(pairs, col_of)
        out["fanout_pairs_off"] = int(((cost != opt) | ~valid).sum())
    else:
        assign = np.asarray(rec["node_assignment"])
        if np.array_equal(np.sort(assign), np.arange(kc)):
            chosen = assign * kc + np.arange(kc)  # the pair (physical k, logical l)
            realized = per_gpu.reshape(kc, gpn).sum(axis=1)[assign]
            out["fanout_pairs_off"] = int((realized != opt[chosen]).sum())
        else:
            out["fanout_pairs_off"] = kc
    node_cost = opt.reshape(kc, kc)
    r, cidx = linear_sum_assignment(node_cost)
    best = node_cost[r, cidx].sum()
    out["relabel_gap"] = float(abs(per_gpu.sum() - best))
    return out


def packing_weights(rec: Dict, jobs: Jobs):
    """The packing graph of a round, worked out again: the (placed,
    pending) weight matrix, zero where no edge may be, and the row and
    column of each job id."""
    placed, pending = rec["placed"], rec["pending"]
    mp = [jobs.model[j] for j in placed.tolist()]
    mq = [jobs.model[j] for j in pending.tolist()]
    models = sorted(set(mp) | set(mq))
    idx = {m: i for i, m in enumerate(models)}
    table = np.array([[jobs.pack_weight(a, b) for b in models] for a in models])
    w = table[np.array([idx[m] for m in mp], np.int64)[:, None], np.array([idx[m] for m in mq], np.int64)[None, :]]
    edge = (
        (jobs.gpus[placed][:, None] == jobs.gpus[pending][None, :])
        & jobs.packable[placed][:, None]
        & jobs.packable[pending][None, :]
    )
    row = {j: i for i, j in enumerate(placed.tolist())}
    col = {j: i for i, j in enumerate(pending.tolist())}
    return np.where(edge, w, 0.0), row, col


def packing_gap(rec: Dict, jobs: Jobs) -> float:
    """The max-weight matching's weight less the program's, over the
    auction's stated bound S / (S + 1) (S the shorter side)."""
    placed, pending, matches = rec["placed"], rec["pending"], rec["matches"]
    if placed.size == 0 or pending.size == 0:
        return 0.0
    w, row, col = packing_weights(rec, jobs)
    r, c = linear_sum_assignment(w, maximize=True)
    best = w[r, c].sum()
    got = sum(w[row[q], col[p]] for p, q in matches.items() if q in row and p in col)
    s = min(placed.size, pending.size)
    return float(max(0.0, best - got) / (s / (s + 1.0)))
