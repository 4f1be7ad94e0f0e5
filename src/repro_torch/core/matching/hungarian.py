"""Hungarian / shortest-augmenting-path solver for the assignment problem.

Tesserae reduces both of its placement policies to linear sum assignment:

* migration minimisation (§4.1, Algorithms 2 & 3) — *minimise* cost,
* packing (§4.2, Algorithm 4) — *maximise* weight (we negate).

This module provides a numpy-vectorised O(n^3) implementation of the
Jonker-Volgenant shortest augmenting path algorithm (the same family scipy
implements) plus a thin dispatcher ``solve_lap`` that can route to scipy —
the backend the paper uses — for large instances.

The implementation follows the classic potentials formulation: for each row
we grow an alternating tree using Dijkstra over reduced costs
``cost[i, j] - u[i] - v[j]`` until a free column is reached, then augment.
The inner column scan is vectorised with numpy, giving O(n^2) numpy work per
row (O(n^3) total) with tiny constants — adequate for the k_l x k_l and
k_c x k_c matrices in Algorithms 2/3 and for packing graphs with thousands
of jobs.
"""

from __future__ import annotations

import numpy as np

_INF = np.inf


def linear_sum_assignment(cost: np.ndarray, maximize: bool = False):
    """Solve the (possibly rectangular) linear sum assignment problem.

    Returns ``(row_ind, col_ind)`` with the same contract as
    ``scipy.optimize.linear_sum_assignment``: ``cost[row_ind, col_ind].sum()``
    is minimal (maximal when ``maximize``), rows are sorted, and
    ``len(row_ind) == min(cost.shape)``.

    Entries may be ``np.inf`` to forbid an assignment (a complete finite
    matching must still exist).
    """
    cost = np.asarray(cost, dtype=np.float64)
    if cost.ndim != 2:
        raise ValueError(f"cost must be 2-D, got shape {cost.shape}")
    if maximize:
        finite = np.isfinite(cost)
        flipped = np.where(finite, -cost, _INF)
        return linear_sum_assignment(flipped, maximize=False)

    n, m = cost.shape
    transposed = n > m
    if transposed:
        cost = cost.T
        n, m = m, n

    # col_to_row[j] = row currently assigned to column j (-1 = free).
    col_to_row = np.full(m, -1, dtype=np.int64)
    u = np.zeros(n, dtype=np.float64)  # row potentials
    v = np.zeros(m, dtype=np.float64)  # column potentials

    for cur_row in range(n):
        # Dijkstra from `cur_row` over columns on reduced costs.
        min_to = np.full(m, _INF, dtype=np.float64)  # shortest path to column j
        prev_col = np.full(m, -1, dtype=np.int64)    # previous column on path
        used = np.zeros(m, dtype=bool)

        i = cur_row
        j_cur = -1  # sentinel "virtual column" attached to cur_row
        while True:
            # Relax all unused columns from row i.
            reduced = cost[i] - u[i] - v
            better = ~used & (reduced < min_to)
            min_to = np.where(better, reduced, min_to)
            prev_col[better] = j_cur

            # Pick the closest unused column.
            masked = np.where(used, _INF, min_to)
            j_next = int(np.argmin(masked))
            delta = masked[j_next]
            if not np.isfinite(delta):
                raise ValueError("infeasible assignment problem (inf block)")

            # Update potentials: tree rows/cols move by delta.
            used_cols = used
            tree_rows = col_to_row[used_cols]
            u[cur_row] += delta
            u[tree_rows] += delta
            v[used_cols] -= delta
            min_to = np.where(used_cols, min_to, min_to - delta)

            used[j_next] = True
            j_cur = j_next
            i = col_to_row[j_next]
            if i == -1:
                break

        # Augment along the alternating path ending at free column j_cur.
        while j_cur != -1:
            j_prev = prev_col[j_cur]
            if j_prev == -1:
                col_to_row[j_cur] = cur_row
            else:
                col_to_row[j_cur] = col_to_row[j_prev]
            j_cur = j_prev

    row_ind = np.empty(n, dtype=np.int64)
    col_ind = np.empty(n, dtype=np.int64)
    k = 0
    for j in range(m):
        if col_to_row[j] >= 0:
            row_ind[k] = col_to_row[j]
            col_ind[k] = j
            k += 1
    order = np.argsort(row_ind[:k])
    row_ind, col_ind = row_ind[:k][order], col_ind[:k][order]
    if transposed:
        order = np.argsort(col_ind)
        return col_ind[order], row_ind[order]
    return row_ind, col_ind


def solve_lap(
    cost: np.ndarray,
    maximize: bool = False,
    backend: str = "auto",
):
    """Dispatch the LAP to a backend.

    ``backend``:
      * ``"auto"``  — scipy when available and n >= 64 (paper-faithful fast
        path), else our numpy implementation.
      * ``"numpy"`` — force our implementation.
      * ``"scipy"`` — force scipy (raises if unavailable).
    """
    cost = np.asarray(cost, dtype=np.float64)
    if backend not in ("auto", "numpy", "scipy"):
        raise ValueError(f"unknown LAP backend {backend!r}")

    use_scipy = backend == "scipy"
    if backend == "auto" and min(cost.shape) >= 64:
        use_scipy = True
    if use_scipy:
        try:
            from scipy.optimize import linear_sum_assignment as scipy_lsa
        except ImportError:  # pragma: no cover - scipy is a dependency
            if backend == "scipy":
                raise
            use_scipy = False
        else:
            # scipy rejects matrices containing inf rows even when feasible
            # via other columns only in degenerate cases; contract matches ours.
            return scipy_lsa(cost, maximize=maximize)
    return linear_sum_assignment(cost, maximize=maximize)


def assignment_cost(cost: np.ndarray, row_ind, col_ind) -> float:
    """Total cost of an assignment (helper used by tests & Algorithm 2)."""
    cost = np.asarray(cost, dtype=np.float64)
    return float(cost[np.asarray(row_ind), np.asarray(col_ind)].sum())
