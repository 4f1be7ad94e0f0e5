"""The control: the plain reference put in the program's place for the
migration relabel (K5, the fan-out and the node match), with one of the
configuration's stated guarantees broken.

The configuration states no floating precision: the Algorithm-3 costs are
multiples of 1/16 no larger than 2, exact in every binary format down to
bf16, so a lower-precision K5 would read the same as the program and could
fail nothing.  The guarantee it breaks instead is the relabel's exactness:
every LAP is solved by an auction that stops at epsilon = 1 (one job's
migration; the step a change that trims bid rounds would take), which is
within n migrations of the optimum, not at it.  Placement and packing stay the
program's.  ``tests/test_bench_control.py`` holds it to coming out not
correct; ``readings.py`` reads it on the card at the cells' sizes.

The control leaves packing alone, so ``packing`` gives packing's number
a fault of its own to read: the packing matching from an auction stopped
after its first phase, at the epsilon the program's auction starts from
(a quarter of the benefit's span, at least 1), instead of at
``1 / (S + 1)``, the step a change that trims bid phases would take.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tesserae_bench.reference import tesserae_round as ref

#: Algorithm-3 costs are multiples of 1 / SCALE
SCALE = 16.0
#: the control's final epsilon, in cost units (one migration)
EPS = 1.0


def coarse_auction(cost: np.ndarray, eps: float = 1.0) -> np.ndarray:
    """Gauss-Seidel forward auction on (B, n, n) costs, one bidder of each
    unfinished instance a step, a single phase at ``eps``.  Returns
    ``col_of`` (B, n)."""
    b, n, _ = cost.shape
    benefit = -np.asarray(cost, dtype=np.float64)
    price = np.zeros((b, n))
    owner = np.full((b, n), -1, np.int64)
    col_of = np.full((b, n), -1, np.int64)
    active = np.arange(b)
    while active.size:
        unassigned = col_of[active] < 0
        keep = unassigned.any(axis=1)
        active, unassigned = active[keep], unassigned[keep]
        if not active.size:
            break
        i = np.argmax(unassigned, axis=1)
        v = benefit[active, i, :] - price[active]
        ar = np.arange(active.size)
        j = np.argmax(v, axis=1)
        v1 = v[ar, j]
        if n > 1:
            v[ar, j] = -np.inf
            v2 = v.max(axis=1)
        else:
            v2 = v1
        price[active, j] += v1 - v2 + eps
        prev = owner[active, j]
        had = prev >= 0
        col_of[active[had], prev[had]] = -1
        owner[active, j] = i
        col_of[active, i] = j
    return col_of


def relabel(rec: Dict, jobs: "ref.Jobs", gpn: int) -> Dict:
    """``rec`` with the relabel stage's outputs replaced by the control's:
    K5's matrix, the fan-out's assignments, the node assignment and the
    physical plan."""
    prev, logical = rec["prev"], rec["logical"]
    kc = logical.shape[0]
    common = np.intersect1d(ref.job_ids(prev), ref.job_ids(logical))
    pc = ref.restrict(prev, common).reshape(kc * gpn, -1)
    lc = ref.restrict(logical, common).reshape(kc * gpn, -1)
    c = ref.cost_matrix(pc, lc, jobs.weight)
    pairs = c.reshape(kc, gpn, kc, gpn).transpose(0, 2, 1, 3).reshape(kc * kc, gpn, gpn)
    col_of = coarse_auction(np.rint(pairs * SCALE), EPS * SCALE)
    totals, _ = ref.assignment_costs(pairs, col_of)
    node_col = coarse_auction(np.rint(totals.reshape(1, kc, kc) * SCALE), EPS * SCALE)[0]
    assign = np.empty(kc, np.int64)
    assign[node_col] = np.arange(kc)  # logical node l -> physical node k
    phys = np.full_like(logical, ref.EMPTY)
    for l in range(kc):
        k = assign[l]
        phys[k, :] = logical[l, col_of[k * kc + l]]
    out = dict(rec)
    out.update(k5=c, pairs_col_of=col_of, node_assignment=assign, phys=phys)
    return out


def first_phase_auction(benefit: np.ndarray, eps: float) -> np.ndarray:
    """Forward auction on one (R, C) max-weight instance, one bidder a step,
    a single phase at ``eps``; the shorter side bids.  Returns the column
    of each row (-1 where a row of the longer side is left over)."""
    flip = benefit.shape[0] > benefit.shape[1]
    b = np.asarray(benefit.T if flip else benefit, dtype=np.float64)
    nr, nc = b.shape
    price = np.zeros(nc)
    owner = np.full(nc, -1, np.int64)
    col_of = np.full(nr, -1, np.int64)
    free = list(range(nr - 1, -1, -1))
    while free:
        i = free.pop()
        v = b[i] - price
        j = int(np.argmax(v))
        v1 = v[j]
        v[j] = -np.inf
        v2 = v.max() if nc > 1 else v1
        price[j] += v1 - v2 + eps
        if owner[j] >= 0:
            col_of[owner[j]] = -1
            free.append(int(owner[j]))
        owner[j] = i
        col_of[i] = j
    if not flip:
        return col_of
    out = np.full(benefit.shape[0], -1, np.int64)
    out[col_of] = np.arange(nr)
    return out


def packing(rec: Dict, jobs: "ref.Jobs") -> Dict:
    """``rec`` with its packing matches replaced by the first-phase
    auction's on the reference's packing graph."""
    if rec["placed"].size == 0 or rec["pending"].size == 0:
        return rec
    w, row, col = ref.packing_weights(rec, jobs)
    eps = max(float(np.abs(w).max()), 1.0) / 4.0
    col_of = first_phase_auction(w, eps)
    placed_of = {i: j for j, i in row.items()}
    pending_of = {i: j for j, i in col.items()}
    out = dict(rec)
    out["matches"] = {
        pending_of[int(c)]: placed_of[r]
        for r, c in enumerate(col_of)
        if c >= 0 and w[r, c] > 0.0
    }
    return out
