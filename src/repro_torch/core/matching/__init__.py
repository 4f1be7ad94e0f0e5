"""Assignment (linear-sum-assignment / LAP) solvers used by Tesserae.

The public entry points are the **unified batched matching engine**
(:mod:`repro_torch.core.matching.engine`):

* :func:`solve_lap_batched` — one call for a whole batch of (rectangular,
  masked, forbidden-edge) LAP instances, dispatched through a backend
  registry (``scipy`` / ``numpy`` / ``smallperm`` / ``auction`` /
  ``auction_kernel`` / ``auto``) with per-instance convergence tracking
  and a scipy fallback for non-converged auction instances.  Rectangular
  instances solve natively (no square embedding) on the rect-capable
  backends.
* :class:`MatchContext` — opaque **identity-keyed** warm-start state a
  scheduler threads across rounds: callers supply instance/row/column
  identities (job ids, node ids, GPU slots) and the context re-assembles
  last round's device-resident auction prices for the surviving
  identities, memoises bit-identical instances (remapped through the
  identity maps, so batches may grow/shrink/permute), and compacts the
  changed instances into a dense sub-batch before solving.
* :func:`solve_lap` — single-instance wrapper with the same backend knob.
* :func:`register_backend` / :func:`available_backends` — plug-in points.

Underlying solvers (importable directly when needed):

* :mod:`repro_torch.core.matching.hungarian` — numpy-vectorised Jonker-Volgenant
  shortest-augmenting-path solver (no scipy dependency) plus the
  scipy dispatcher the paper itself uses (§5 "We use Scipy to ... solve
  the weighted bipartite graph matching problem").
* :mod:`repro_torch.core.matching.auction` — batched torch auction solver
  (beyond-paper): Algorithm 2 solves k_c**2 independent node-level LAPs,
  which batch into ONE loop over the instance stack, with the bid step
  optionally on the hand-written ``lap_bid`` CUDA kernel.
"""

from repro_torch.core.matching.auction import (
    auction_assignment,
    auction_lap,
    auction_lap_batched,
    auction_lap_rect_batched,
    masked_rect_benefit,
    masked_square_benefit,
)
from repro_torch.core.matching.engine import (
    BatchedMatchResult,
    MatchContext,
    available_backends,
    register_backend,
    solve_lap,
    solve_lap_batched,
)
from repro_torch.core.matching.hungarian import assignment_cost, linear_sum_assignment

__all__ = [
    "BatchedMatchResult",
    "MatchContext",
    "assignment_cost",
    "auction_assignment",
    "auction_lap",
    "auction_lap_batched",
    "auction_lap_rect_batched",
    "available_backends",
    "linear_sum_assignment",
    "masked_rect_benefit",
    "masked_square_benefit",
    "register_backend",
    "solve_lap",
    "solve_lap_batched",
]
