"""Plain reference of one Tesserae round on a mixed-generation, racked
cluster, in NumPy and SciPy, importing nothing of the program.

It judges the same round as ``tesserae_round`` (K5's matrix, the fan-out,
the relabel, packing, feasibility) under the typed semantics the
``hetero-256gpu`` configuration states:

* node types and racks follow from the plan's node count ``kc`` by the
  configuration's rule: nodes ``[0, kc // 2)`` are A100, the rest V100,
  and racks hold ``kc // 4`` consecutive nodes;
* the node match's optimum is over the fan-out's pair optima plus the
  relabel penalties: ``2 * gpn * kc + 1`` for a logical node on a physical
  node of another type (more than any real relabel costs, so the optimum
  is type-preserving) and ``0.5`` for one moved to another rack;
* each packed pair is weighed on the GPU type of its placed job's node (the
  node of the job's lowest logical GPU), with that type's HBM and speed:
  a pair over a V100's 16 GB is no edge.

Feasibility adds two rules to the paper reference's: no logical node is
relabelled onto a physical node of another type, and no packed pair weighs
0 on its node's type.  Costs and penalties are multiples of 1/16, so the
relabel's comparison is exact in f64.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

from tesserae_bench import tput
from tesserae_bench.reference import tesserae_round as base

EMPTY = base.EMPTY

#: GPU type -> (HBM GB, speed relative to an A100); frozen from the port's
#: ``core/profiler.py`` ``GPU_TYPES``
GPU_TYPES = {"a100": (40.0, 1.0), "v100": (16.0, 0.45)}
TYPE_NAMES = ("a100", "v100")
#: the node match's cost of moving a logical node to another rack
CROSS_RACK_COST = 0.5


def node_types(kc: int) -> np.ndarray:
    """Each node's index into ``TYPE_NAMES``: the first half A100."""
    return (np.arange(kc) >= kc // 2).astype(np.int64)


def node_racks(kc: int) -> np.ndarray:
    """Each node's rack: ``kc // 4`` consecutive nodes a rack (one rack
    below 4 nodes)."""
    return np.arange(kc) // (kc // 4 or kc)


def cluster(kc: int, gpn: int) -> Dict:
    """The configuration's cluster cut to ``kc`` nodes, by its rule."""
    return dict(
        num_nodes=kc,
        gpus_per_node=gpn,
        node_gpu_types=[TYPE_NAMES[t] for t in node_types(kc)],
        nodes_per_rack=kc // 4,
    )


def penalties(types: np.ndarray, racks: np.ndarray, gpn: int) -> np.ndarray:
    """(kc, kc) node-match penalties of nodes of GPU types ``types`` in
    racks ``racks``: ``[k, l]`` for logical node ``l`` on physical node
    ``k``."""
    kc = len(types)
    mismatch = (2.0 * gpn * kc + 1.0) * (types[:, None] != types[None, :])
    return mismatch + CROSS_RACK_COST * (racks[:, None] != racks[None, :])


def _normalized_packed(a: str, b: str, mem: float, strat_a: str) -> tuple:
    """``tput.normalized_packed`` on a GPU of ``mem`` GB."""
    ma, mb = tput.mem_gb(a, strat_a), tput.mem_gb(b)
    if ma + mb > mem:
        return 0.0, 0.0
    ca, cb = tput.MODELS[a][0], tput.MODELS[b][0]
    overlap = ca * cb + (1 - ca) * (1 - cb)
    interference = tput.GAMMA + (1 - tput.GAMMA) * overlap
    mem_util = (ma + mb) / mem
    interference *= 0.55 + 0.75 * mem_util
    wiggle = 1.0 + tput.JITTER * (2 * tput._pair_hash_unit(a, b) - 1)
    na = wiggle / (1.0 + interference)
    skew = 0.06 * (ca - cb)
    return (
        float(np.clip(na * (1 + skew), 0.05, 1.0)),
        float(np.clip(na * (1 - skew), 0.05, 1.0)),
    )


def combined_weight(a: str, b: str, gpu: str) -> float:
    """``tput.combined_weight`` of placed ``a`` and pending ``b`` on a GPU
    of type ``gpu``."""
    mem, speed = GPU_TYPES[gpu]

    def iso(s):
        return tput.MODELS[a][2] * speed * 1 * tput._strategy_factors(a, s)[0]

    best = 0.0
    dp = iso("dp")
    for s in tput.strategies(a):
        na, nb = _normalized_packed(a, b, mem, s)
        w = iso(s) / dp * na + nb
        if w > best:
            best = w
    return best


class Jobs(base.Jobs):
    """The paper reference's job table, with packing weights per GPU type."""

    def pack_weight(self, a: str, b: str, gpu: str = "a100") -> float:
        key = (a, b, gpu)
        w = self._pair_w.get(key)
        if w is None:
            w = self._pair_w[key] = combined_weight(a, b, gpu)
        return w


def placed_types(rec: Dict) -> np.ndarray:
    """The type index of each placed job's node in the logical plan (the
    node of its lowest GPU), -1 for a job the plan lacks."""
    logical = rec["logical"]
    kc, gpn = logical.shape[:2]
    flat = logical.reshape(kc * gpn, -1)
    gpu = np.repeat(np.arange(kc * gpn), flat.shape[1])
    ids = flat.ravel()
    keep = ids != EMPTY
    ids, gpu = ids[keep], gpu[keep]
    first: Dict[int, int] = {}
    for j, g in zip(ids[::-1].tolist(), gpu[::-1].tolist()):
        first[j] = g  # walked backwards, so the lowest GPU is kept
    types = node_types(kc)
    return np.array([types[first[q] // gpn] if q in first else -1 for q in rec["placed"].tolist()],
                    np.int64)


def infeasibility(rec: Dict, jobs: Jobs, gpn: int, prev_phys: Optional[np.ndarray]) -> int:
    """The paper reference's count, plus a relabel across types and a packed
    pair that weighs 0 on its node's type."""
    bad = base.infeasibility(rec, jobs, gpn, prev_phys)
    kc = rec["logical"].shape[0]
    types = node_types(kc)
    assign = np.asarray(rec["node_assignment"])
    if np.array_equal(np.sort(assign), np.arange(kc)):
        bad += int((types[assign] != types).any())
    matches = rec["matches"]
    if matches:
        tq = dict(zip(rec["placed"].tolist(), placed_types(rec).tolist()))
        for p, q in matches.items():
            t = tq.get(q, -1)
            if t < 0 or jobs.pack_weight(jobs.model[q], jobs.model[p], TYPE_NAMES[t]) <= 0.0:
                bad += 1
                break
    return bad


def relabel_numbers(rec: Dict, jobs: Jobs, gpn: int) -> Dict[str, float]:
    """K5's cells off and fan-out instances off their optimum, as in the
    paper reference, and how far the plan's relabel (its true cost plus
    its penalties) lies from the penalised node match's optimum."""
    prev, logical, phys = rec["prev"], rec["logical"], rec["phys"]
    kc = logical.shape[0]
    common = np.intersect1d(base.job_ids(prev), base.job_ids(logical))
    pc = base.restrict(prev, common).reshape(kc * gpn, -1)
    lc = base.restrict(logical, common).reshape(kc * gpn, -1)
    c = base.cost_matrix(pc, lc, jobs.weight)
    out: Dict[str, float] = {}
    k5 = rec.get("k5")
    if k5 is not None:
        out["k5_cells_off"] = c.size if k5.shape != c.shape else int((k5 != c).sum())
    pairs = c.reshape(kc, gpn, kc, gpn).transpose(0, 2, 1, 3).reshape(kc * kc, gpn, gpn)
    opt = base.pair_optima(pairs)
    physc = base.restrict(phys, common).reshape(kc * gpn, -1)
    per_node = base.row_costs(pc, physc, jobs.weight).reshape(kc, gpn).sum(axis=1)
    assign = np.asarray(rec["node_assignment"])
    valid = np.array_equal(np.sort(assign), np.arange(kc))
    col_of = rec.get("pairs_col_of")
    if col_of is not None:
        cost, ok = base.assignment_costs(pairs, col_of)
        out["fanout_pairs_off"] = int(((cost != opt) | ~ok).sum())
    elif valid:
        chosen = assign * kc + np.arange(kc)  # the pair (physical k, logical l)
        out["fanout_pairs_off"] = int((per_node[assign] != opt[chosen]).sum())
    else:
        out["fanout_pairs_off"] = kc
    pen = penalties(node_types(kc), node_racks(kc), gpn)
    node_cost = opt.reshape(kc, kc) + pen
    r, cidx = linear_sum_assignment(node_cost)
    best = node_cost[r, cidx].sum()
    if valid:
        got = per_node.sum() + pen[assign, np.arange(kc)].sum()
        out["relabel_gap"] = float(abs(got - best))
    else:
        out["relabel_gap"] = float(pen.max())
    return out


def packing_weights(rec: Dict, jobs: Jobs):
    """The packing graph of a round, each placed row weighed on its node's
    type: the (placed, pending) weight matrix, zero where no edge may be,
    and the row and column of each job id."""
    placed, pending = rec["placed"], rec["pending"]
    mp = [jobs.model[j] for j in placed.tolist()]
    mq = [jobs.model[j] for j in pending.tolist()]
    models = sorted(set(mp) | set(mq))
    idx = {m: i for i, m in enumerate(models)}
    table = np.array(
        [[[jobs.pack_weight(a, b, t) for b in models] for a in models] for t in TYPE_NAMES]
    )
    rt = placed_types(rec)
    w = table[
        np.maximum(rt, 0)[:, None],
        np.array([idx[m] for m in mp], np.int64)[:, None],
        np.array([idx[m] for m in mq], np.int64)[None, :],
    ]
    edge = (
        (rt >= 0)[:, None]
        & (jobs.gpus[placed][:, None] == jobs.gpus[pending][None, :])
        & jobs.packable[placed][:, None]
        & jobs.packable[pending][None, :]
    )
    row = {j: i for i, j in enumerate(placed.tolist())}
    col = {j: i for i, j in enumerate(pending.tolist())}
    return np.where(edge, w, 0.0), row, col


def packing_gap(rec: Dict, jobs: Jobs) -> float:
    """The max-weight matching's weight less the program's, under the
    typed weights, over the auction's stated bound S / (S + 1)."""
    placed, pending, matches = rec["placed"], rec["pending"], rec["matches"]
    if placed.size == 0 or pending.size == 0:
        return 0.0
    w, row, col = packing_weights(rec, jobs)
    r, c = linear_sum_assignment(w, maximize=True)
    best = w[r, c].sum()
    got = sum(w[row[q], col[p]] for p, q in matches.items() if q in row and p in col)
    s = min(placed.size, pending.size)
    return float(max(0.0, best - got) / (s / (s + 1.0)))
