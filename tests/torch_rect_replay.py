"""Packing-shaped rectangular replays whose warm rounds re-solve exactly.

A batch of (n, m) max-weight rectangles, rows placed jobs and columns
pending jobs, whose jobs churn from round to round.  Each job has one of
``models`` types and a cell's weight is a fixed per-type-pair value, so a
few types give many ties and many types nearly none.  :func:`stale_prices`
seeds the high stale prices of ``test_rect_certificate_fires_identically``
on the columns the last auction left unassigned: the next warm auction
cannot reach them, its price certificate fails, and the exact re-solve it
falls back to is adopted.  Imports neither JAX nor the JAX package, so the
card's tests use it too.
"""

import numpy as np
import torch

from repro_torch.core.matching import MatchContext, solve_lap_batched
from repro_torch.obs import Observability


def packing_replay(seed, rounds, n, m, batch=1, models=64, churn=1):
    """Rounds of (costs (B, n, m), instance_ids, row_ids, col_ids): in each
    round after the first, ``churn`` placed jobs of every instance finish,
    as many pending jobs take their places and as many new ones arrive."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(0.2, 2.0, size=(models, models))
    model = []

    def new():
        model.append(int(rng.integers(models)))
        return len(model) - 1

    placed = [[new() for _ in range(n)] for _ in range(batch)]
    pending = [[new() for _ in range(m)] for _ in range(batch)]
    out = []
    for r in range(rounds):
        for b in range(batch if r else 0):
            for _ in range(churn):
                taken = pending[b].pop(int(rng.integers(len(pending[b]))))
                placed[b] = placed[b][1:] + [taken]
                pending[b].append(new())
        kind = np.array(model)
        costs = np.stack([table[kind[p]][:, kind[q]] for p, q in zip(placed, pending)])
        out.append(
            (costs, np.arange(batch, dtype=np.int64), np.array(placed), np.array(pending))
        )
    return out


def stale_prices(prices, col_solve, instances=None):
    """``prices`` (B, C) with 1e6 on each column ``col_solve`` (B, R) leaves
    unassigned, in ``instances`` (default all); the same type as given:
    a numpy array or a tensor on its device."""
    b, c = prices.shape
    assigned = np.zeros((b, c + 1), bool)
    np.put_along_axis(assigned, np.where(col_solve >= 0, col_solve, c), True, axis=1)
    keep = assigned[:, :c]
    if instances is not None:
        keep[np.setdiff1d(np.arange(b), instances)] = True
    if isinstance(prices, torch.Tensor):
        return torch.where(torch.from_numpy(keep).to(prices.device), prices, 1e6)
    return np.where(keep, np.asarray(prices), 1e6).astype(np.float32)


def traced_packing(rounds, backend, device):
    """``rounds`` through one traced context as the ``packing`` family,
    with :func:`stale_prices` before every round after the first.  Returns
    the results and each solve's ``lap.fallback`` attributes (None where it
    has none)."""
    ctx = MatchContext(device=device)
    ctx.obs = Observability()
    results = []
    for k, (costs, inst, rows, cols) in enumerate(rounds):
        if k:
            (e,) = ctx._entries.values()
            e.prices = stale_prices(e.prices, e.col_solve)
        results.append(
            solve_lap_batched(
                costs, maximize=True, backend=backend, context=ctx, context_key="packing",
                instance_ids=inst, row_ids=rows, col_ids=cols,
            )
        )
    fallbacks = [
        next((c.attrs for c in s.children if c.name == "lap.fallback"), None)
        for s in ctx.obs.tracer.roots()
        if s.name == "lap.solve"
    ]
    return results, fallbacks
