"""Unified batched matching engine — one entry point for every LAP in Tesserae.

Algorithm 2 solves k_c^2 independent node-pair LAPs per scheduling round,
packing (Algorithm 4) solves one rectangular max-weight matching, and the
final node-level match is one more square LAP.  Before this module each
call site picked its own solver (sequential scipy loops in
``migration.py``, ``hungarian.solve_lap`` in ``packing.py``, a bespoke
auction path in ``plan_migration_batched_auction``).  The engine unifies
them behind a *backend registry*:

==================  =========================================================
``scipy``           per-instance ``scipy.optimize.linear_sum_assignment``
                    (the paper-faithful reference; exact).  Rectangular
                    instances solve natively (no square embedding).
``numpy``           per-instance :mod:`repro_torch.core.matching.hungarian` (exact,
                    no scipy dependency).  Rectangular instances solve
                    natively.
``smallperm``       vectorised brute force over all k! permutations — exact
                    and ~100x faster than looped Hungarian for the k <= 6
                    node-pair instances of Algorithm 2 (k_l is 4-8 on every
                    evaluated cluster).  Square-embedded.
``auction``         batched torch auction (`auction_lap_batched`): one
                    batched loop for the whole fan-out; totals within the
                    documented ``n * eps`` bound of optimal (exact for
                    integer-valued costs).  Warm-startable (below); n != m
                    instances route to the native rectangular forward
                    auction — bids range only over real columns and no
                    ``max(n, m)^2`` square embedding is allocated.
``auction_kernel``  auction with the bid top-2 on the hand-written
                    ``lap_bid`` CUDA kernel (its plain version for CPU
                    tensors).  Same warm-start / rectangular semantics as
                    ``auction``.
``auto``            ``smallperm`` when every instance is k <= 6, else
                    ``scipy`` when available, else ``numpy``
==================  =========================================================

All backends accept **rectangular** instances, **row/col masks** (padding —
so ragged batches solve in one call) and **forbidden edges** (non-finite
cost entries).  Square and ``smallperm`` instances normalise through the
square *benefit* embedding (:func:`~repro_torch.core.matching.auction.
masked_square_benefit`); rectangular instances keep their (n, m) shape
(:func:`~repro_torch.core.matching.auction.masked_rect_benefit`), oriented so
bidders are the short side.  Padded and forbidden cells get a constant
benefit strictly below every real benefit, which guarantees padding never
displaces a real pair in an optimal (or ``n*eps``-optimal) assignment.
Results are post-processed uniformly: pairs landing on padded/forbidden
cells are dropped, and — for the auction backends — instances whose
auction did not converge within the iteration budget (or, on the
rectangular path, whose warm-start price certificate fails, see below) are
transparently re-solved with an exact backend.

**Identity-keyed warm starts** (:class:`MatchContext`): placements change
little round-to-round (the temporal locality Tesserae's migration matching
exploits, Fig. 2/14b), so the scheduler threads an opaque ``MatchContext``
across rounds.  Cached state is keyed by *identity*, not by shape:

==================  =========================================================
``instance_ids``    (B,) — who each batch instance *is* (a node pair of the
                    Algorithm-2 fan-out, the packing graph, ...).  Supplied
                    by the caller; defaults to batch position.
``row_ids``         (B, N) or (N,) — identity of each cost row (a physical
                    GPU slot, a placed job id, ...).  Defaults to position.
``col_ids``         (B, M) or (M,) — identity of each cost column (a
                    logical GPU slot, a pending job id, ...).
==================  =========================================================

Reuse rules (per instance, after matching identities across rounds):

* **memo** — same row/col identity sets and bit-identical benefit cells:
  the cached assignment is remapped through the identity maps and reused
  outright (zero bid iterations; assignments are *bit-for-bit* those of a
  fresh solve because the fingerprint comparison is exact, see below).
* **warm** — surviving column identities re-assemble last round's auction
  **prices** (new columns start cold at 0); a content-changed or vanished
  row invalidates the price of the column it held last round.  Instances
  whose only delta is added/removed/permuted identities skip the
  epsilon-scaling schedule (one phase at ``eps_min``); instances with
  content-changed rows restart the full schedule with the surviving
  prices as a head start.
* **invalidation** — anything else (orientation flip, context-key or
  backend change, unseen instance id) is a cold start.
* **departed-identity LRU** — prices of identities that LEAVE a family are
  parked in a bounded per-family LRU; an identity resuming after absent
  rounds (Tiresias demotion-resume) re-enters with its parked prices as a
  head start (single phase at ``eps_min`` — valid for any initial prices)
  but is *not* reported warm: its content was never fingerprint-verified.

**Deterministic tie-breaking** (``tie_break=True``): equally-optimal
assignments are normally solver-dependent (scipy row order vs auction bid
order).  The canonical perturbation (:func:`_tie_break_perturb`) makes the
optimum unique without leaving the original optimal set; for integral
benefits the auction epsilon is tightened below the perturbation quantum,
so EVERY backend returns the identical assignment — the churn-replay
differential compares physical plans bit-for-bit across backends under
this flag.  Default off (seed assignments preserved).

**Partial-batch compaction**: instances that memo-hit never occupy solver
lanes — the changed instances are gathered into a dense sub-batch, solved,
and scattered back next to the memoised results, preserving per-instance
``converged`` / ``used_fallback`` flags.  (The JAX package pads the
sub-batch to a power-of-two bucket to reuse jit signatures; eager torch
has none to reuse, and the padding changes no instance's result.)

**Device residency**: prices and benefit fingerprints live on the
context's ``device`` as torch tensors end-to-end — identity matching,
price re-assembly, the rectangular price certificate and the save-time
price repair are device computations, and host copies happen only at the
documented readouts (counted in ``stats["host_syncs"]``).  Fingerprints
are the exact f64 bit patterns of the benefit cells, held as an ``int64``
view (torch's uint32 coverage is thin); the npz files carry them as two
uint32 lanes per cell, the JAX package's layout, so a context saved by
either package loads in the other.  Fingerprint equality is
collision-free: a memo hit can never return a stale result.

Optimality under warm starts: for square instances the ``S * eps_min``
bound holds for ANY initial prices (both sides of the comparison telescope
over the same full column set).  For rectangular instances it additionally
requires that no unassigned column's final price exceeds an assigned
column's — the engine checks exactly that a posteriori
(:func:`_rect_bound_violation`) and re-solves the rare instance whose
certificate fails, so every returned total carries the documented bound.

Accuracy contract: with ``backend="auction"`` the returned per-instance
total cost is within ``S * eps_min`` of the scipy optimum, where ``S`` is
the solve size (the embedded square for n == m, the short side for
rectangular instances) and ``eps_min`` defaults to ``1 / (S + 1)`` — i.e.
*exact* whenever costs are integers (quantise first when exactness
matters; migration costs are multiples of ``1/(2*num_gpus)`` and are
scaled to integers by the caller).  The exact backends match scipy
identically, and with a context they memo/compact exactly like the
auction backends (minus price state).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.matching import hungarian
from repro_torch.core.matching.auction import masked_rect_benefit, masked_square_benefit
from repro_torch.device import device_timer, resolve_device
from repro_torch.obs.tracer import NULL_TRACER, NullTracer

#: Largest instance size solved by brute-force permutation search (k! <= 720).
SMALLPERM_MAX_K = 6

#: Backends whose totals carry the n*eps approximation bound (float costs).
APPROX_BACKENDS = ("auction", "auction_kernel")

#: Backends that solve rectangular (n != m) instances natively, without the
#: max(n, m)^2 square embedding.
RECT_BACKENDS = ("scipy", "numpy", "auction", "auction_kernel")

#: Synthetic identity base for rows/cols the square embedding pads in;
#: caller-supplied identities must stay above this (they are job/node/GPU
#: ids in practice, so any id > -2^40 is safe).
_PAD_ID_BASE = -(1 << 40)

#: Default capacity of the departed-identity price LRU (see MatchContext).
_DEPARTED_LRU_CAPACITY = 4096


def _tb_ranks(ids: Optional[np.ndarray], k: int) -> np.ndarray:
    """1-based tie-break ranks of each row/column identity within its
    instance: the rank of ``ids[b, i]`` among instance ``b``'s REAL ids
    (ascending), with synthetic embedding pads (<= ``_PAD_ID_BASE``)
    ranked after every real id in POSITION order.  ``ids=None`` degenerates
    to positions — bit-identical to the historical position-canonical
    ramp, and identical to materialised default ids (``arange`` + pads).
    Ranks depend only on the identity SET, so a surviving identity keeps
    its perturbation when the batch or its rows/columns permute."""
    if ids is None:
        return np.arange(1.0, k + 1.0)[None, :]
    pos = np.arange(k, dtype=np.int64)
    key = np.where(ids > _PAD_ID_BASE, ids, (1 << 62) + pos)
    order = np.argsort(key, axis=1, kind="stable")
    rank = np.empty(ids.shape, np.float64)
    np.put_along_axis(
        rank, order, np.broadcast_to(np.arange(k, dtype=np.float64), ids.shape), axis=1
    )
    return rank + 1.0


def _tie_break_perturb(
    benefit: np.ndarray,
    row_ids: Optional[np.ndarray] = None,
    col_ids: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[float]]:
    """Canonical tie-break perturbation (``tie_break=True``).

    Adds ``scale * r_i^2 * c_j`` to every cell of the embedded benefit,
    where ``r_i`` / ``c_j`` are the 1-based :func:`_tb_ranks` of the row /
    column IDENTITY within its instance (positions when no identities are
    supplied) — a canonical ramp under which two assignments that differ
    by swapping tied rows/columns (the dominant tie pattern: same-model
    pending jobs, interchangeable empty nodes) ALWAYS get distinct totals
    (the pairwise-swap delta is ``(r2^2-r1^2)(c2-c1) != 0``; some
    higher-order rotations can still collide — documented best effort).
    ``scale`` is a power of two small enough that any assignment's total
    perturbation stays below half the benefit quantum, so the perturbed
    optimum is always one of the ORIGINAL optima:

    * integral benefits (quantised migration costs): quantum 1.  Returns
      the scale so the caller can tighten the auction epsilon below it —
      the perturbed problem then has a unique optimum that EVERY backend
      (exact f64 or f32 auction) finds, making equally-optimal
      assignments solver-independent.
    * float benefits (packing throughputs): quantum ``span * 2^-20`` — a
      relative-precision heuristic, NOT a lower bound on real gaps, so
      for floats the optimal-set preservation is best-effort: two
      assignments whose true totals differ by less than ~``span * 2^-21``
      may be reordered (a relative error below 5e-7 — far inside the
      profile-noise floor these weights carry anyway).  The perturbation
      canonicalises the exact f64 backends; it is below f32 resolution,
      so the auction keeps its documented ``S*eps`` bound unchanged
      (returns ``None``: no epsilon tightening).

    Identity-keyed rather than position-canonical: a surviving (row_id,
    col_id) cell keeps its perturbed value when the batch or the rows /
    columns inside an instance permute, so identity-keyed memo/warm hits
    survive packing-graph permutations with tie-breaking on.  Ranks are a
    pure function of the per-instance identity set, so every backend
    still sees the identical perturbed instance — cross-solver parity is
    unconditional.
    """
    b, n, m = benefit.shape
    integral = bool(np.all(benefit == np.rint(benefit)))
    if integral:
        quantum = 1.0
    else:
        span = float(np.abs(benefit).max())
        quantum = max(span, 1.0) * 2.0**-20
    rr = _tb_ranks(row_ids, n)  # (B or 1, n)
    cc = _tb_ranks(col_ids, m)  # (B or 1, m)
    w = (rr**2)[:, :, None] * cc[:, None, :]
    # any assignment picks min(n, m) cells, each below n^2 * m
    bound = 2.0 * min(n, m) * float(n) * float(n) * float(m)
    scale = 2.0 ** np.floor(np.log2(quantum / bound))
    return benefit + scale * w, (float(scale) if integral else None)


def _benefit_total(benefit_nm: np.ndarray, col_of: np.ndarray) -> np.ndarray:
    """Per-instance total of ``benefit_nm`` cells selected by ``col_of``
    (original row space; -1 = unassigned).  Used to rank a primary solve
    against its exact fallback in PERTURBED space when tie-breaking."""
    b, n, m = benefit_nm.shape
    cols = col_of[:, :n]
    valid = (cols >= 0) & (cols < m)
    safe = np.where(valid, cols, 0)
    picked = np.take_along_axis(benefit_nm, safe[:, :, None], axis=2)[:, :, 0]
    return np.where(valid, picked, 0.0).sum(axis=1)


# --------------------------------------------------------------------------- #
# Result type
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class BatchedMatchResult:
    """Assignments for a batch of LAP instances.

    ``col_of[b, i]`` is the column assigned to row ``i`` of instance ``b``
    (-1 for unassigned / masked / padded rows).  ``total_cost[b]`` sums the
    ORIGINAL cost entries over assigned pairs.  ``converged[b]`` reports
    whether the primary backend solved the instance itself;
    ``used_fallback[b]`` marks instances re-solved by the exact fallback.
    ``bid_iters[b]`` counts auction bid rounds (0 for exact backends and
    memo hits); ``warm[b]`` marks instances served from a
    :class:`MatchContext` (memo hits and price-warm solves); ``embedding``
    records the solve geometry (``"square"`` / ``"rect"`` / ``"none"`` for
    empty batches).
    """

    col_of: np.ndarray      # (B, N) int64
    total_cost: np.ndarray  # (B,) float64
    converged: np.ndarray   # (B,) bool
    used_fallback: np.ndarray  # (B,) bool
    backend: str
    wall_time_s: float = 0.0
    bid_iters: Optional[np.ndarray] = None  # (B,) int64
    warm: Optional[np.ndarray] = None       # (B,) bool
    embedding: str = "square"

    def pairs(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """(row_ind, col_ind) of instance ``b`` — scipy-style contract."""
        rows = np.nonzero(self.col_of[b] >= 0)[0]
        return rows, self.col_of[b, rows]


# --------------------------------------------------------------------------- #
# Persistent warm-start state
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class _CtxEntry:
    """Identity-keyed state cached from the previous solve of one family.

    ``fp_bits``, ``prices`` and ``ids_dev`` are tensors on the context's
    device; everything needed for host control flow (identities,
    assignments, flags) stays numpy.
    """

    instance_ids: np.ndarray    # (B,) int64
    row_ids: np.ndarray         # (B, Ne) int64, original orientation (incl. pad ids)
    col_ids: np.ndarray         # (B, Me) int64
    transposed: bool
    rect: bool
    real_shape: Tuple[int, int]  # (n, m) before any square embedding
    fp_bits: torch.Tensor       # (B, Ne, Me) int64 — exact f64 bit pattern
    prices: Optional[torch.Tensor]  # (B, C) float32 — oriented column prices
    owner: Optional[np.ndarray]  # (B, C) int64 — oriented col -> owning oriented row
    col_solve: np.ndarray       # (B, R) int64 oriented solve-space assignment
    final_col_of: np.ndarray    # (B, N) int64 original-space assignment
    converged: np.ndarray       # (B,) bool
    used_fallback: np.ndarray   # (B,) bool
    #: int64 device copies of (instance_ids, row_ids, col_ids) for the
    #: device-side match prologue
    ids_dev: Optional[tuple] = None


class MatchContext:
    """Opaque identity-keyed warm-start state for :func:`solve_lap_batched`.

    The scheduler creates one and threads it across rounds; each engine
    call site picks a ``context_key`` (e.g. ``"migration_pairs"``,
    ``"packing"``) so different LAP families never collide.  Per family
    the context stores, keyed by the caller-supplied instance/row/column
    *identities*: exact benefit fingerprints, the final auction **prices**
    (device-resident), and the final assignment.  See the module docstring
    for the memo / warm / invalidation semantics.

    A bounded **departed-identity LRU** rides along: when an instance or
    column identity leaves a family (a job finishes or is demoted, a node
    pair drops out of the fan-out), its final auction price is parked in a
    per-family LRU instead of being forgotten.  An identity that RETURNS
    after one or more absent rounds (the Tiresias demotion-resume pattern
    — the dominant Philly-trace event after plain arrivals) re-enters with
    its parked price as a head start instead of bidding up from zero.
    Correctness is unaffected: any initial price vector is valid (module
    docstring), and restored instances still run the full epsilon schedule
    (plus the rectangular certificate), so every bound survives.

    ``device`` holds the cached tensors and runs the auction solves that
    go through this context (default CUDA; pass ``"cpu"`` explicitly).

    Thread-safety: none — one context per scheduler instance.
    """

    def __init__(
        self, departed_lru_capacity: int = _DEPARTED_LRU_CAPACITY, device=None
    ):
        self.device = resolve_device(device)
        self._entries: Dict[tuple, _CtxEntry] = {}
        #: (context_key, backend) -> OrderedDict[(instance_id, col_id) -> price]
        self._departed: Dict[tuple, "OrderedDict[Tuple[int, int], float]"] = {}
        self.departed_lru_capacity = departed_lru_capacity
        #: opt-in observability bundle (repro_torch.obs.Observability) — when set
        #: (TesseraeScheduler.set_observability), solve_lap_batched emits a
        #: span per engine call with this context's stat deltas.  Never
        #: serialised with the context payload; the owner re-attaches it.
        self.obs = None
        self.stats: Dict[str, int] = {
            "solves": 0,          # engine calls that consulted this context
            "memo_hits": 0,       # calls where EVERY instance memo-hit
            "memo_instances": 0,  # instances served from cache (0 bid iters)
            "warm_instances": 0,  # memo + price-warm instances
            "cold_instances": 0,
            "rows_invalidated": 0,  # price resets from changed/vanished rows
            "cert_violations": 0,   # rect bound certificate failures
            "compacted_solves": 0,  # calls that solved a proper sub-batch
            "bid_iters": 0,         # total auction bid rounds through this context
            "lru_parked_cols": 0,   # departed column prices parked in the LRU
            "lru_restored_cols": 0,  # cold columns re-seeded from the LRU
            "lru_dropped_cols": 0,   # parked prices dropped on shrink-return
            "host_syncs": 0,         # device->host readouts through this ctx
            "instances_invalidated": 0,  # targeted invalidations (node faults)
        }

    def get(self, key: tuple) -> Optional[_CtxEntry]:
        return self._entries.get(key)

    def store(self, key: tuple, entry: _CtxEntry) -> None:
        """Keep ONE entry per (context_key, backend) family: identities are
        matched against the *latest* round only, so an older round's state
        is dead weight — and without eviction a long-running scheduler
        would grow the cache by one entry per (maximize, eps) variant ever
        seen.  Prices of identities the new entry no longer carries are
        parked in the departed-identity LRU on the way out."""
        family = key[:2]
        old = self._entries.get(key)
        if (
            old is not None
            and old.prices is not None
            and self.departed_lru_capacity > 0
        ):
            # the LRU family carries the ORIENTATION: a transposed solve's
            # price columns are original rows, and parking them under the
            # same family as untransposed column prices would let a price
            # cross identity spaces on restore
            self._park_departed(family + (old.transposed,), old, entry)
        for k in [k for k in self._entries if k[:2] == family and k != key]:
            del self._entries[k]
        self._entries[key] = entry

    # -- departed-identity LRU ------------------------------------------- #
    @staticmethod
    def _oriented_col_ids(entry: _CtxEntry) -> np.ndarray:
        """Identity of each ORIENTED price column: original columns, or —
        for transposed rectangular solves, where the original rows bid as
        columns — the original row ids."""
        return entry.row_ids if entry.transposed else entry.col_ids

    def _park_departed(self, family: tuple, old: _CtxEntry, new: _CtxEntry) -> None:
        oc_old = self._oriented_col_ids(old)
        oc_new = self._oriented_col_ids(new)
        if (
            old.transposed == new.transposed
            and old.instance_ids.shape == new.instance_ids.shape
            and oc_old.shape == oc_new.shape
            and np.array_equal(old.instance_ids, new.instance_ids)
            and np.array_equal(oc_old, oc_new)
        ):
            return  # steady state: nothing departed
        pos = _positions_in(old.instance_ids[None, :], new.instance_ids[None, :])[0]
        safe = np.clip(pos, 0, new.instance_ids.shape[0] - 1)
        col_pos = _positions_in(oc_old, oc_new[safe])
        departed = ((col_pos < 0) | (pos < 0)[:, None]) & (oc_old > _PAD_ID_BASE)
        bb, cc = np.nonzero(departed)
        if bb.size == 0:
            return
        # one small device->host transfer of ONLY the departed prices
        pd = old.prices.device
        vals = (
            old.prices[torch.from_numpy(bb).to(pd), torch.from_numpy(cc).to(pd)]
            .cpu()
            .numpy()
            .astype(np.float32)
        )
        self.stats["host_syncs"] += 1
        lru = self._departed.setdefault(family, OrderedDict())
        parked = 0
        for b, c, v in zip(bb, cc, vals):
            if v == 0.0:
                continue  # a cold price is not worth a slot
            k = (int(old.instance_ids[b]), int(oc_old[b, c]))
            lru.pop(k, None)
            lru[k] = float(v)
            parked += 1
        self.stats["lru_parked_cols"] += parked
        while len(lru) > self.departed_lru_capacity:
            lru.popitem(last=False)

    def restore_departed(
        self,
        family: tuple,
        instance_ids: np.ndarray,
        oriented_col_ids: np.ndarray,
        cold_mask: np.ndarray,
    ) -> Optional[np.ndarray]:
        """Prices for cold (b, c) slots whose identity is parked in the
        LRU, or ``None`` when nothing matches.  Hits are popped — the
        price returns to the live entry at the next ``store``.

        A RETURNING instance consumes every parked entry it owns, whether
        or not the parked column identity is still present: an identity
        that departs and returns with a *changed* column set (the
        shrink-then-return pattern) must get its surviving columns
        restored and its no-longer-present columns DROPPED — a stale
        parked price that lingered past the return could otherwise be
        restored into a later, unrelated incarnation of the column id,
        whose equilibrium it no longer approximates.  (Restores are keyed
        by column identity, never zipped positionally, so a changed
        column ORDER is always safe.)

        Iterates the BOUNDED LRU (not the cold cells): a large fan-out
        with a few percent churn has far more cold slots than parked
        prices, and the per-instance column lookup is built lazily only
        for instances the LRU actually mentions."""
        lru = self._departed.get(family)
        if not lru:
            return None
        inst_pos: Dict[int, int] = {}
        for b, v in enumerate(instance_ids):
            inst_pos.setdefault(int(v), b)
        out = None
        restored = 0
        dropped = 0
        col_lut: Dict[int, Dict[int, int]] = {}
        for (iid, cid), price in list(lru.items()):
            b = inst_pos.get(iid)
            if b is None:
                continue  # instance still absent: keep its prices parked
            lut = col_lut.get(b)
            if lut is None:
                lut = col_lut[b] = {
                    int(v): j for j, v in enumerate(oriented_col_ids[b])
                }
            j = lut.get(cid)
            del lru[(iid, cid)]
            if j is None or not cold_mask[b, j]:
                # column gone (shrink-then-return) or already carrying a
                # live price that supersedes the parked one: drop it
                dropped += 1
                continue
            if out is None:
                out = np.zeros(cold_mask.shape, np.float32)
            out[b, j] = price
            restored += 1
        self.stats["lru_restored_cols"] += restored
        self.stats["lru_dropped_cols"] += dropped
        return out

    def invalidate_instances(self, instance_ids, families=None) -> int:
        """TARGETED invalidation of specific instance identities (the
        node-fault path): poison their cached benefit fingerprints and
        zero their warm prices, in every family (or only the
        ``context_key`` names listed in ``families``), and drop their
        parked departed-identity prices.

        The poison pattern is all-ones (int64 -1; all-ones in both uint32
        lanes of the npz layout) — the f64 NaN bit pattern, which no real (finite) benefit cell can ever carry —
        so the next solve's exact fingerprint compare is GUARANTEED to
        miss: the instance re-solves cold (full epsilon schedule, zero
        prices, always valid) while every other instance's memo/warm
        state survives untouched.  Returns the number of cached instances
        invalidated.
        """
        ids = np.asarray(list(instance_ids), dtype=np.int64).reshape(-1)
        if ids.size == 0:
            return 0
        count = 0
        for key, entry in self._entries.items():
            if families is not None and key[0] not in families:
                continue
            hit = np.nonzero(np.isin(entry.instance_ids, ids))[0]
            if hit.size == 0:
                continue
            idx = torch.from_numpy(hit).to(entry.fp_bits.device)
            entry.fp_bits = entry.fp_bits.index_fill(0, idx, -1)
            if entry.prices is not None:
                entry.prices = entry.prices.index_fill(0, idx.to(entry.prices.device), 0.0)
            count += int(hit.size)
        id_set = {int(i) for i in ids}
        for fam, lru in self._departed.items():
            if families is not None and fam[0] not in families:
                continue
            for k in [k for k in lru if k[0] in id_set]:
                del lru[k]
        self.stats["instances_invalidated"] += count
        return count

    # -- snapshot / restore (crash-resume) -------------------------------- #
    STATE_VERSION = "tesserae-matchctx-v1"

    def state_payload(self) -> Tuple[Dict, Dict[str, np.ndarray]]:
        """The context's full state as ``(json-able meta, arrays)`` — the
        building block :meth:`save` writes to disk and the simulator
        embeds (key-prefixed) inside its own round-state snapshot."""
        arrays: Dict[str, np.ndarray] = {}
        meta: Dict = {
            "version": self.STATE_VERSION,
            "lru_capacity": self.departed_lru_capacity,
            "stats": dict(self.stats),
            "entries": [],
            "lru": [],
        }
        for i, (key, e) in enumerate(self._entries.items()):
            meta["entries"].append(
                {
                    "key": list(key),
                    "transposed": bool(e.transposed),
                    "rect": bool(e.rect),
                    "real_shape": list(e.real_shape),
                    "has_prices": e.prices is not None,
                    "has_owner": e.owner is not None,
                }
            )
            p = f"e{i}."
            arrays[p + "instance_ids"] = e.instance_ids
            arrays[p + "row_ids"] = e.row_ids
            arrays[p + "col_ids"] = e.col_ids
            arrays[p + "fp_bits"] = _bits_to_lanes(e.fp_bits)
            if e.prices is not None:
                arrays[p + "prices"] = e.prices.cpu().numpy().astype(np.float32)
            if e.owner is not None:
                arrays[p + "owner"] = e.owner
            arrays[p + "col_solve"] = e.col_solve
            arrays[p + "final_col_of"] = e.final_col_of
            arrays[p + "converged"] = e.converged
            arrays[p + "used_fallback"] = e.used_fallback
        for j, (fam, lru) in enumerate(self._departed.items()):
            meta["lru"].append({"family": list(fam)})
            keys = np.array(list(lru.keys()), np.int64).reshape(-1, 2)
            vals = np.array(list(lru.values()), np.float32)
            arrays[f"lru{j}.keys"] = keys
            arrays[f"lru{j}.vals"] = vals
        return meta, arrays

    def save(self, path: str) -> None:
        """Serialise the full warm-start state to a versioned ``.npz``.

        Everything that affects future solves round-trips: per-family
        entries (identities, exact fingerprints, prices, assignments),
        the departed-identity LRUs (in recency order) and the stats
        counters.  :meth:`load` restores a context whose subsequent
        solves are bit-identical to one that never left memory — the
        crash-resume differential test gates on exactly that.
        """
        meta, arrays = self.state_payload()
        arrays["meta_json"] = np.array(json.dumps(meta))
        # write through a file object so numpy never appends ".npz"
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def from_payload(
        cls, meta: Dict, get: Callable[[str], np.ndarray], device=None
    ) -> "MatchContext":
        """Rebuild a context from a :meth:`state_payload` meta dict and an
        array accessor (``get(name) -> ndarray``) — the JAX package's
        payloads included.  Device tensors (fingerprints, prices, the
        prologue's id copies) are re-materialised on ``device``."""
        if meta.get("version") != cls.STATE_VERSION:
            raise ValueError(
                f"MatchContext state version {meta.get('version')!r} != "
                f"{cls.STATE_VERSION!r}"
            )
        ctx = cls(departed_lru_capacity=int(meta["lru_capacity"]), device=device)
        dev = ctx.device
        ctx.stats.update(meta["stats"])
        for i, em in enumerate(meta["entries"]):
            p = f"e{i}."
            k = em["key"]
            key = (k[0], k[1], bool(k[2]), k[3], bool(k[4]))
            inst = get(p + "instance_ids")
            rids = get(p + "row_ids")
            cids = get(p + "col_ids")
            ctx._entries[key] = _CtxEntry(
                instance_ids=inst,
                row_ids=rids,
                col_ids=cids,
                transposed=bool(em["transposed"]),
                rect=bool(em["rect"]),
                real_shape=tuple(em["real_shape"]),
                fp_bits=_lanes_to_bits(get(p + "fp_bits"), dev),
                prices=(
                    torch.from_numpy(np.array(get(p + "prices"), np.float32)).to(dev)
                    if em["has_prices"]
                    else None
                ),
                owner=get(p + "owner") if em["has_owner"] else None,
                col_solve=get(p + "col_solve"),
                final_col_of=get(p + "final_col_of"),
                converged=get(p + "converged"),
                used_fallback=get(p + "used_fallback"),
                ids_dev=_ids_to_device(inst, rids, cids, dev),
            )
        for j, lm in enumerate(meta["lru"]):
            fam = tuple(
                bool(v) if isinstance(v, bool) else v for v in lm["family"]
            )
            lru: "OrderedDict[Tuple[int, int], float]" = OrderedDict()
            for (iid, cid), v in zip(get(f"lru{j}.keys"), get(f"lru{j}.vals")):
                lru[(int(iid), int(cid))] = float(v)
            ctx._departed[fam] = lru
        return ctx

    @classmethod
    def load(cls, path: str, device=None) -> "MatchContext":
        """Rebuild a context from :meth:`save` output (either package's)."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta_json"][()]))
            return cls.from_payload(meta, lambda name: z[name], device=device)

    def reset(self) -> None:
        """Drop all cached state (prices, fingerprints, memoised results,
        parked departed-identity prices)."""
        self._entries.clear()
        self._departed.clear()

    def __len__(self) -> int:
        return len(self._entries)


# --------------------------------------------------------------------------- #
# Identity bookkeeping (host)
# --------------------------------------------------------------------------- #
def _as_instance_ids(ids, b: int) -> np.ndarray:
    if ids is None:
        return np.arange(b, dtype=np.int64)
    out = np.asarray(ids, dtype=np.int64).reshape(-1)
    if out.shape != (b,):
        raise ValueError(f"instance_ids must have shape ({b},), got {out.shape}")
    return out


def _as_id_matrix(ids, b: int, k: int, name: str) -> np.ndarray:
    if ids is None:
        return np.broadcast_to(np.arange(k, dtype=np.int64), (b, k))
    ids = np.asarray(ids, dtype=np.int64)
    if ids.ndim == 1:
        ids = np.broadcast_to(ids, (b, ids.shape[0]))
    if ids.shape != (b, k):
        raise ValueError(f"{name} must have shape ({b}, {k}), got {ids.shape}")
    return ids


def _pad_ids(ids: np.ndarray, size: int) -> np.ndarray:
    """Extend per-instance identities with synthetic ids for the rows/cols
    the square embedding pads in (stable across rounds, so an unchanged
    padded instance still memo-hits)."""
    b, k = ids.shape
    if k == size:
        return ids
    pad = _PAD_ID_BASE - np.arange(size - k, dtype=np.int64)
    return np.concatenate([ids, np.broadcast_to(pad, (b, size - k))], axis=1)


def _positions_in(new_ids: np.ndarray, old_ids: np.ndarray) -> np.ndarray:
    """Per-instance identity lookup: position of each ``new_ids[b, i]`` in
    ``old_ids[b, :]`` (first occurrence), or -1 when absent.  Vectorised
    over the batch via disjoint per-row key ranges + one flat searchsorted.
    """
    b, k0 = old_ids.shape
    if b == 0 or k0 == 0 or new_ids.shape[1] == 0:
        return np.full(new_ids.shape, -1, np.int64)
    if new_ids.shape == old_ids.shape and np.array_equal(new_ids, old_ids):
        return np.broadcast_to(
            np.arange(new_ids.shape[1], dtype=np.int64), new_ids.shape
        ).copy()
    lo = min(int(new_ids.min()), int(old_ids.min()))
    hi = max(int(new_ids.max()), int(old_ids.max()))
    span = hi - lo + 1
    if span * b < (1 << 62):
        order = np.argsort(old_ids, axis=1, kind="stable")
        sorted_old = np.take_along_axis(old_ids, order, axis=1)
        off = np.arange(b, dtype=np.int64)[:, None] * span
        flat_old = (sorted_old - lo + off).ravel()
        flat_new = (new_ids - lo + off).ravel()
        loc = np.minimum(np.searchsorted(flat_old, flat_new), flat_old.size - 1)
        hit = flat_old[loc] == flat_new
        return np.where(hit, order.ravel()[loc], -1).reshape(new_ids.shape)
    # id range too wide for the offset trick: per-row dict fallback
    out = np.full(new_ids.shape, -1, np.int64)
    for i in range(b):  # pragma: no cover - exotic ids only
        lut = {int(v): j for j, v in reversed(list(enumerate(old_ids[i])))}
        for j, v in enumerate(new_ids[i]):
            out[i, j] = lut.get(int(v), -1)
    return out


def _invert_pos(pos: np.ndarray, k_old: int) -> np.ndarray:
    """Invert per-instance position maps: ``pos`` (B, K_new) holds old
    positions (or -1); returns (B, K_old) with ``inv[b, pos[b, j]] = j``."""
    b = pos.shape[0]
    inv = np.full((b, k_old), -1, np.int64)
    bb, jj = np.nonzero(pos >= 0)
    inv[bb, pos[bb, jj]] = jj
    return inv


# --------------------------------------------------------------------------- #
# Device-resident fingerprints + price machinery
# --------------------------------------------------------------------------- #
def _f64_bits(a: np.ndarray) -> np.ndarray:
    """Exact fingerprint of f64 values: the raw bit pattern as an int64
    view, ``(...,) f64 -> (...,) int64``.  Equality of fingerprints is
    equality of bit patterns — collision-free (note -0.0 != +0.0 at the
    bit level; the spurious invalidation is harmless)."""
    return np.ascontiguousarray(a, dtype=np.float64).view(np.int64)


def _bits_to_lanes(bits: torch.Tensor) -> np.ndarray:
    """npz boundary: int64 fingerprints -> the JAX package's ``(..., 2)``
    uint32 lanes (the same little-endian bytes)."""
    h = np.ascontiguousarray(bits.cpu().numpy(), dtype=np.int64)
    return h.view(np.uint32).reshape(*h.shape, 2)


def _lanes_to_bits(lanes: np.ndarray, device) -> torch.Tensor:
    """npz boundary: ``(..., 2)`` uint32 lanes -> int64 fingerprints."""
    lanes = np.ascontiguousarray(lanes, dtype=np.uint32)
    return torch.from_numpy(lanes.view(np.int64).reshape(lanes.shape[:-1]).copy()).to(device)


def _ids_to_device(inst, rids, cids, device) -> tuple:
    return tuple(
        torch.from_numpy(np.array(x, dtype=np.int64)).to(device)
        for x in (inst, rids, cids)
    )


def _rows_unchanged_dev(new_bits, old_bits, old_idx, row_pos, col_pos):
    """Per-row exact change detection on device.

    ``new_bits`` (B, N, M) int64; ``old_bits`` (B0, N0, M0);
    ``old_idx`` (B,) instance match (-1 = cold); ``row_pos`` (B, N) /
    ``col_pos`` (B, M) identity positions in the old instance (-1 = new).
    A row is unchanged iff it existed last round and every SURVIVING
    column's cell is bit-identical (new columns don't count against it).
    """
    ob = old_idx.clamp_min(0)
    rp = row_pos.clamp_min(0)
    cp = col_pos.clamp_min(0)
    gathered = old_bits[ob[:, None, None], rp[:, :, None], cp[:, None, :]]
    eq = torch.where((col_pos >= 0)[:, None, :], gathered == new_bits, True)
    return (row_pos >= 0) & (old_idx >= 0)[:, None] & eq.all(dim=-1)


def _assigned_cols(col_solve: np.ndarray, c: int) -> np.ndarray:
    """(B, C) bool mask of columns holding an assignment.  Scatters only
    the real (>= 0) entries — clipping -1 sentinels into index 0 would let
    an unassigned row clobber column 0's flag."""
    b = col_solve.shape[0]
    assigned = np.zeros((b, c), bool)
    bb, rr = np.nonzero(col_solve >= 0)
    assigned[bb, col_solve[bb, rr]] = True
    return assigned


def _rect_bound_violation(prices, col_solve) -> np.ndarray:
    """A-posteriori certificate for the rectangular ``n*eps`` bound.

    At termination the auction satisfies eps-complementary slackness wrt
    its FINAL prices, which yields (for any competing assignment S'):

        total(sigma) >= total(S') - R*eps - [sum_{S'\\sigma} p - sum_{sigma\\S'} p]

    The bracket is <= 0 for every S' iff no k largest unassigned-column
    prices sum above the k smallest assigned-column prices (pairwise), so

        D = max_k  sum_{i<k} (U_desc[i] - A_asc[i])  >  0

    is the exact condition under which warm-start prices could have broken
    the bound (see the JAX package for the full argument).  Instances with
    unassigned rows return False — the convergence / cardinality checks
    already flag them.

    ``prices`` is a device tensor — the check runs on its device and only
    the (B,) verdict is copied to the host.
    """
    b, c = prices.shape
    r = col_solve.shape[1]
    if r >= c or b == 0:
        return np.zeros(b, bool)  # square: bound holds for any prices
    verdict = _rect_violation_dev(
        prices.to(torch.float32),
        torch.from_numpy(np.ascontiguousarray(col_solve, dtype=np.int64)).to(prices.device),
    )
    return verdict.cpu().numpy()


def _rect_violation_dev(prices, col_solve):
    b, c = prices.shape
    r = col_solve.shape[1]
    ok = col_solve >= 0
    safe = torch.where(ok, col_solve, c)
    assigned = torch.zeros((b, c + 1), dtype=torch.bool, device=prices.device)
    assigned = assigned.scatter(1, safe, True)[:, :c]
    complete = ok.all(dim=1)
    inf = torch.tensor(float("inf"), dtype=prices.dtype, device=prices.device)
    a_sorted = torch.sort(torch.where(assigned, prices, inf), dim=1).values[:, :r]
    u_sorted = -torch.sort(torch.where(assigned, inf, -prices), dim=1).values[:, : c - r]
    k = min(r, c - r)
    diff = u_sorted[:, :k] - a_sorted[:, :k]
    d_worst = torch.cumsum(torch.where(torch.isfinite(diff), diff, 0.0), dim=1).amax(dim=1)
    # Tolerance matches the slack the parity gates grant on top of the
    # documented S*eps_min bound; erring tight is safe (a false positive
    # only costs an exact re-solve).  Cold solves have d_worst <= 0.
    return complete & (d_worst > 1e-6)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def _bucketed_bits(bits: torch.Tensor) -> torch.Tensor:
    """Zero-pad a (B, N, M) fingerprint tensor to power-of-two B/N/M, the
    shape the JAX package stores (so saved contexts carry identical
    arrays).  Padded cells are never consulted: padded batch entries carry
    ``old_idx == -1``, padded rows ``row_pos == -1`` and padded columns
    ``col_pos == -1``."""
    b, n, m = bits.shape
    nb, nn, nm = _next_pow2(b), _next_pow2(n), _next_pow2(m)
    if (nb, nn, nm) == (b, n, m):
        return bits
    out = torch.zeros((nb, nn, nm), dtype=bits.dtype, device=bits.device)
    out[:b, :n, :m] = bits
    return out


# --------------------------------------------------------------------------- #
# Device-side identity matching (match prologue)
# --------------------------------------------------------------------------- #
# Torch keeps int64 on device, so the prologue matches the caller's int64
# identities directly — the JAX package's int32 re-encoding bands (x64 is
# off there) and its host fallback for ids outside them have no
# counterpart here; the matches are the host matches either way.
def _positions_in_dev(new_ids: torch.Tensor, old_ids: torch.Tensor) -> torch.Tensor:
    """Device counterpart of :func:`_positions_in`: position of each
    ``new_ids[b, i]`` in ``old_ids[b, :]`` (first occurrence, via stable
    argsort + left searchsorted — the same tie rule as the host path), or
    -1 when absent."""
    order = torch.argsort(old_ids, dim=1, stable=True)
    sorted_old = torch.gather(old_ids, 1, order).contiguous()
    loc = torch.searchsorted(sorted_old, new_ids.contiguous(), side="left")
    loc = loc.clamp_max(old_ids.shape[1] - 1)
    hit = torch.gather(sorted_old, 1, loc) == new_ids
    return torch.where(hit, torch.gather(order, 1, loc), -1)


def _match_prologue_dev(
    inst, old_inst, rids, old_rids, cids, old_cids, new_bits, old_bits
):
    """The context-lookup prologue on device: instance matching, row/column
    identity matching and the exact fingerprint compare, read back by the
    caller in ONE transfer."""
    old_idx = _positions_in_dev(inst[None, :], old_inst[None, :])[0]
    safe_b = old_idx.clamp(0, old_inst.shape[0] - 1)
    matched = old_idx >= 0
    row_pos = torch.where(
        matched[:, None], _positions_in_dev(rids, old_rids[safe_b]), -1
    )
    col_pos = torch.where(
        matched[:, None], _positions_in_dev(cids, old_cids[safe_b]), -1
    )
    unchanged = _rows_unchanged_dev(new_bits, old_bits, old_idx, row_pos, col_pos)
    return old_idx, row_pos, col_pos, unchanged

# --------------------------------------------------------------------------- #
# Backend registry
# --------------------------------------------------------------------------- #
#: name -> fn(benefit (B,R,C), eps_min, max_iters) -> (col_of (B,R), converged (B,))
_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str) -> Callable:
    """Register a batched benefit solver under ``name``.

    The callable receives the benefit batch (maximise convention, padding
    already applied; square-embedded unless the backend is listed in
    ``RECT_BACKENDS``) and returns per-row column assignments plus a
    per-instance convergence flag.  Third-party schedulers can plug in
    e.g. a Sinkhorn or GPU-resident solver without touching any call site
    — backend choice stays one config knob.
    """

    def deco(fn: Callable) -> Callable:
        _BACKENDS[name] = fn
        return fn

    return deco


def available_backends() -> List[str]:
    return sorted(_BACKENDS) + ["auto"]


@register_backend("scipy")
def _solve_scipy(benefit: np.ndarray, eps_min=None, max_iters=None):
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    b, r, _ = benefit.shape
    col_of = np.full((b, r), -1, dtype=np.int64)
    for i in range(b):
        rows, cols = scipy_lsa(benefit[i], maximize=True)
        col_of[i, rows] = cols
    return col_of, np.ones(b, dtype=bool)


@register_backend("numpy")
def _solve_numpy(benefit: np.ndarray, eps_min=None, max_iters=None):
    b, r, _ = benefit.shape
    col_of = np.full((b, r), -1, dtype=np.int64)
    for i in range(b):
        rows, cols = hungarian.linear_sum_assignment(benefit[i], maximize=True)
        col_of[i, rows] = cols
    return col_of, np.ones(b, dtype=bool)


@register_backend("smallperm")
def _solve_smallperm(benefit: np.ndarray, eps_min=None, max_iters=None):
    """Exact batched LAP for k <= 6 by vectorised permutation search.

    Replaces the k_c^2 sequential Hungarian calls in Algorithm 2's
    node-pair fan-out with one numpy pass — the node size k_l is 4-8 in
    every evaluated cluster, where k! brute force beats O(k^3) with Python
    overhead by ~100x (EXPERIMENTS.md §Perf, scheduler iteration 2).
    """
    b, k, _ = benefit.shape
    if k > SMALLPERM_MAX_K:
        raise ValueError(f"smallperm requires k <= {SMALLPERM_MAX_K}, got {k}")
    perms = np.array(list(itertools.permutations(range(k))), dtype=np.int64)
    picked = benefit[:, np.arange(k)[None, :], perms]  # (B, P, k)
    best = np.argmax(picked.sum(axis=-1), axis=-1)  # maximise benefit
    return perms[best], np.ones(b, dtype=bool)


def _solve_auction(benefit: np.ndarray, eps_min, max_iters, use_kernel: bool, device):
    col_of, converged, _, _ = _run_auction(
        benefit, False, eps_min, max_iters, use_kernel, None, None, resolve_device(device)
    )
    return col_of, converged


@register_backend("auction")
def _solve_auction_plain(benefit: np.ndarray, eps_min=None, max_iters=20_000, device=None):
    return _solve_auction(benefit, eps_min, max_iters, False, device)


@register_backend("auction_kernel")
def _solve_auction_kernel(benefit: np.ndarray, eps_min=None, max_iters=20_000, device=None):
    return _solve_auction(benefit, eps_min, max_iters, True, device)


def _pick_auto(size: int) -> str:
    if size <= SMALLPERM_MAX_K:
        return "smallperm"
    return _pick_exact()


def _pick_exact() -> str:
    try:
        import scipy.optimize  # noqa: F401

        return "scipy"
    except ImportError:  # pragma: no cover - scipy is a dependency
        return "numpy"


def _run_auction(
    benefit: np.ndarray,
    rect: bool,
    eps_min,
    max_iters: int,
    use_kernel: bool,
    init_prices: Optional[torch.Tensor],
    warm: Optional[np.ndarray],
    device: torch.device,
    span=None,
):
    """Dispatch a (possibly warm-started) auction solve on ``device``.
    Returns (col_of (B, R), converged (B,), prices (B, C) DEVICE tensor,
    iters (B,)) — only the assignment readout crosses back to host, in one
    transfer; prices stay on device so a context caches them without a
    round-trip.  A traced ``span`` (``lap.run``) gets the device time of
    the kernel backend's one ``lap_auction`` launch, read after the
    readout."""
    from repro_torch.core.matching.auction import (
        auction_lap_batched,
        auction_lap_rect_batched,
    )

    solver = auction_lap_rect_batched if rect else auction_lap_batched
    benefit32 = np.ascontiguousarray(benefit, dtype=np.float32)
    with device_timer(span, device) as timer:
        res = solver(
            torch.from_numpy(benefit32).to(device),
            max_iters=max_iters,
            eps_min=eps_min,
            use_kernel=use_kernel,
            init_prices=init_prices,
            warm=None if warm is None else torch.from_numpy(np.asarray(warm, bool)).to(device),
            timer=timer,
        )
        r = res.col_of.shape[1]
        packed = torch.cat(
            [res.col_of, res.converged[:, None].long(), res.iters[:, None].long()], dim=1
        ).cpu().numpy()
    return packed[:, :r], packed[:, r].astype(bool), res.prices, packed[:, r + 1]


class _AheadCount:
    """Instances whose exact re-solve started on the host worker before
    the auction, and what became of it: ``used`` by the fallback, or
    ``dropped`` (the certificate passed, or the instance memo-hit)."""

    def __init__(self) -> None:
        self.started = self.used = self.dropped = 0


#: process-wide tally of the exact re-solves started ahead (instances)
exact_ahead = _AheadCount()

_ahead_pool: Optional[ThreadPoolExecutor] = None
_ahead_pool_lock = threading.Lock()


def _ahead_worker() -> ThreadPoolExecutor:
    """The one worker thread, made at first use."""
    global _ahead_pool
    with _ahead_pool_lock:
        if _ahead_pool is None:
            _ahead_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="lap-exact")
        return _ahead_pool


class _Ahead:
    """The exact re-solve of the instances ``pred`` of one call, started on
    one process-wide host worker as soon as their benefit exists.  The
    worker runs the exact backend alone, on a private copy: no torch, no
    device, no context.  :meth:`join` or :meth:`drop` ends it."""

    __slots__ = ("pred", "future")

    def __init__(self, backend: str, oriented: np.ndarray, pred: np.ndarray):
        self.pred = pred
        self.future = _ahead_worker().submit(
            _BACKENDS[backend], np.ascontiguousarray(oriented[pred]), None, None
        )
        exact_ahead.started += int(pred.size)

    def drop(self) -> None:
        """Leave the answer unread: no wait, and an error it raised is lost."""
        self.future.cancel()
        exact_ahead.dropped += int(self.pred.size)

    def join(self, solve: Callable, oriented: np.ndarray, idx: np.ndarray):
        """``solve``'s assignments of ``oriented[idx]``: the worker's for
        the instances it has, the rest solved here in one call first.
        Returns them with the count taken from the worker and the seconds
        the join blocked."""
        pos = np.minimum(np.searchsorted(self.pred, idx), self.pred.size - 1)
        hit = self.pred[pos] == idx
        if not hit.any():
            self.drop()
            return solve(oriented[idx], None, None)[0], 0, 0.0
        out = np.empty((idx.size, oriented.shape[1]), np.int64)
        if not hit.all():
            out[~hit] = solve(oriented[idx[~hit]], None, None)[0]
        t = time.perf_counter()
        early = self.future.result()[0]
        wait_s = time.perf_counter() - t
        out[hit] = early[pos[hit]]
        used = int(hit.sum())
        exact_ahead.used += used
        exact_ahead.dropped += int(self.pred.size) - used
        return out, used, wait_s


class _Stages:
    """The consecutive child spans of one ``lap.solve``: opening a stage
    closes the one before it, so together they cover the solve.  A stage
    opened with a ``syncs`` attribute gets, at its close, the context's
    device-to-host readouts made inside it (``stats["host_syncs"]``)."""

    __slots__ = ("_tracer", "_stats", "_ctx", "_span", "_syncs0")

    def __init__(self, tracer, context: MatchContext):
        self._tracer = tracer
        self._stats = context.stats
        self._ctx = self._span = None
        self._syncs0 = 0

    def open(self, name: str, **attrs):
        self.close()
        self._ctx = self._tracer.span(name, **attrs)
        self._span = self._ctx.__enter__()
        self._syncs0 = self._stats["host_syncs"]
        return self._span

    def close(self) -> None:
        if self._ctx is None:
            return
        if "syncs" in self._span.attrs:
            self._span.annotate(syncs=self._stats["host_syncs"] - self._syncs0)
        self._ctx.__exit__(None, None, None)
        self._ctx = self._span = None


class _NoStages:
    """The untraced stand-in for :class:`_Stages`."""

    __slots__ = ()

    def open(self, name: str, **attrs):
        return NULL_TRACER.span(name)

    def close(self) -> None:
        pass


_NO_STAGES = _NoStages()


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #
def solve_lap_batched(
    costs: np.ndarray,
    *,
    maximize: bool = False,
    row_mask: Optional[np.ndarray] = None,
    col_mask: Optional[np.ndarray] = None,
    backend: str = "auto",
    eps_min: Optional[float] = None,
    max_iters: int = 20_000,
    context: Optional[MatchContext] = None,
    context_key: str = "default",
    instance_ids: Optional[np.ndarray] = None,
    row_ids: Optional[np.ndarray] = None,
    col_ids: Optional[np.ndarray] = None,
    tie_break: bool = False,
    device=None,
) -> BatchedMatchResult:
    """Solve a batch of (rectangular, masked) LAPs with one backend call.

    When the ``context`` carries an observability bundle (``context.obs``,
    attached by ``TesseraeScheduler.set_observability``), each call emits a
    ``lap.solve`` span annotated with the per-family context-stat deltas
    (memo/warm/cold instances, bid iters, host syncs) and the solve
    outcome — pure host-side bookkeeping over numbers the solve already
    read back; no extra device work.  Its children split the call into
    stages: ``lap.prepare`` (validation, benefit, fingerprint upload),
    ``lap.identity`` (identity match, memo and warm assembly), ``lap.run``
    (the solver on the instances not memoised; on CUDA with the device
    time of the auction kernel), ``lap.check`` (readout, cardinality,
    certificate), ``lap.fallback`` (only when an exact re-solve runs) and
    ``lap.store`` (the context write-back).

    On the auction backends, an instance whose last solve in the context
    adopted the exact answer gets its exact re-solve started on a host
    worker before the identity match, so it runs while the auction does;
    the fallback takes that answer where the instance needs it
    (``lap.fallback``'s ``ahead`` counts them, ``wait_ms`` is the join's
    block) and drops it otherwise.  Results are those of the re-solve run
    in place; :data:`exact_ahead` tallies started, used and dropped.

    Args:
      costs: (B, N, M) cost batch (host numpy array).  ``+inf`` under
        minimisation (``-inf`` under maximisation) marks a forbidden edge.
        NaN, and infinities of the OPPOSITE sign (an "infinitely
        attractive" edge), are rejected with a ``ValueError`` naming the
        offending instance — they would otherwise flow into the auction as
        silently-forbidden edges and can surface as non-convergence.
        Pass a single (N, M) instance to get B=1.
      maximize: maximise total cost instead of minimising.
      row_mask / col_mask: (B, N) / (B, M) bool, True = real.  Padded rows
        and columns never receive an assignment.
      backend: a registered backend name or ``"auto"``.
      eps_min: auction final epsilon (default ``1/(S+1)``; the auction
        total is within ``S*eps_min`` of optimal — exact for integer costs).
      max_iters: auction bid-round budget; instances that exhaust it fall
        back to an exact solver (tracked per instance via ``used_fallback``).
      context: optional :class:`MatchContext` carrying last round's prices,
        fingerprints and assignments — memoises unchanged instances and
        warm-starts the changed ones (see the module docstring).
      context_key: namespace inside ``context`` (one per LAP family, e.g.
        ``"migration_pairs"`` vs ``"packing"``), so unrelated call sites
        never share price state.
      instance_ids / row_ids / col_ids: identities the context keys its
        state by (see the module docstring table).  Defaults to positions,
        which preserves positional warm starts for fixed-shape callers;
        callers with churning batches (jobs arriving/finishing) must pass
        stable identities to keep surviving state warm across shape
        changes.  Identities must be unique within an instance and greater
        than ``-2^40`` (smaller values are reserved for embedding pads).
      tie_break: apply the canonical tie-break perturbation
        (:func:`_tie_break_perturb`) so equally-optimal assignments are
        solver-independent — for integral benefits the auction epsilon is
        tightened below the perturbation quantum, making the returned
        assignment bit-for-bit the one every exact backend returns.
        Default off: the unperturbed (seed) assignments are preserved.
      device: where the auction backends solve when no ``context`` is
        given (default CUDA); with a context, the context's device.
    """
    obs = getattr(context, "obs", None) if context is not None else None
    kwargs = dict(
        maximize=maximize,
        row_mask=row_mask,
        col_mask=col_mask,
        backend=backend,
        eps_min=eps_min,
        max_iters=max_iters,
        context=context,
        context_key=context_key,
        instance_ids=instance_ids,
        row_ids=row_ids,
        col_ids=col_ids,
        tie_break=tie_break,
        device=device,
    )
    if obs is None:
        return _solve_lap_batched_impl(costs, **kwargs)
    batch = int(costs.shape[0]) if getattr(costs, "ndim", 2) == 3 else 1
    before = dict(context.stats)
    with obs.tracer.span("lap.solve", family=context_key, batch=batch) as sp:
        res = _solve_lap_batched_impl(costs, tracer=obs.tracer, **kwargs)
        # host-side annotation only: converged/used_fallback are numpy
        # results the solve already transferred
        sp.annotate(
            backend=res.backend,
            embedding=res.embedding,
            converged=int(np.count_nonzero(res.converged)),
            fallbacks=int(np.count_nonzero(res.used_fallback)),
            **{
                k: int(v - before.get(k, 0))
                for k, v in context.stats.items()
                if v != before.get(k, 0)
            },
        )
    return res


def _solve_lap_batched_impl(
    costs: np.ndarray,
    *,
    maximize: bool = False,
    row_mask: Optional[np.ndarray] = None,
    col_mask: Optional[np.ndarray] = None,
    backend: str = "auto",
    eps_min: Optional[float] = None,
    max_iters: int = 20_000,
    context: Optional[MatchContext] = None,
    context_key: str = "default",
    instance_ids: Optional[np.ndarray] = None,
    row_ids: Optional[np.ndarray] = None,
    col_ids: Optional[np.ndarray] = None,
    tie_break: bool = False,
    device=None,
    tracer=NULL_TRACER,
) -> BatchedMatchResult:
    """The batched-LAP engine body — see :func:`solve_lap_batched` for the
    full contract (the public name is a thin tracing wrapper; ``tracer``
    gets the stage spans under its ``lap.solve``)."""
    t0 = time.perf_counter()
    stages = (
        _NO_STAGES
        if context is None or isinstance(tracer, NullTracer)
        else _Stages(tracer, context)
    )
    traced = stages is not _NO_STAGES
    stages.open("lap.prepare")
    costs = np.asarray(costs, dtype=np.float64)
    if costs.ndim == 2:
        costs = costs[None]
        if row_mask is not None:
            row_mask = np.asarray(row_mask, bool)[None]
        if col_mask is not None:
            col_mask = np.asarray(col_mask, bool)[None]
    if costs.ndim != 3:
        raise ValueError(f"costs must be (B, N, M), got shape {costs.shape}")
    b, n, m = costs.shape
    # input validation: NaN never means anything, and an infinity of the
    # attractive sign (-inf minimize / +inf maximize) is not the documented
    # forbidden-edge encoding — both would be silently treated as forbidden
    # by the benefit masking and can surface rounds later as an unexplained
    # non-convergence.  Fail loudly, naming the instance.
    invalid = np.isnan(costs) | (np.isinf(costs) & ((costs > 0) == bool(maximize)))
    if invalid.any():
        bb, rr, cc = np.nonzero(invalid)
        ids = _as_instance_ids(instance_ids, b)
        val = costs[bb[0], rr[0], cc[0]]
        raise ValueError(
            f"solve_lap_batched: invalid cost entry {val!r} at "
            f"(row {rr[0]}, col {cc[0]}) of instance id {ids[bb[0]]} "
            f"(batch index {bb[0]}, context_key={context_key!r}, "
            f"maximize={maximize}); {int(invalid.sum())} invalid entr"
            f"{'y' if invalid.sum() == 1 else 'ies'} total.  Forbidden "
            f"edges must be {'-inf' if maximize else '+inf'}."
        )
    size = max(n, m)
    if backend == "auto":
        backend = _pick_auto(size)
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown LAP backend {backend!r}; registered: {available_backends()}"
        )
    if b == 0 or n == 0 or m == 0:
        stages.close()
        return BatchedMatchResult(
            np.full((b, n), -1, np.int64),
            np.zeros(b),
            np.ones(b, bool),
            np.zeros(b, bool),
            backend,
            time.perf_counter() - t0,
            np.zeros(b, np.int64),
            np.zeros(b, bool),
            "none",
        )

    approx = backend in APPROX_BACKENDS
    rect = n != m and backend in RECT_BACKENDS
    transposed = rect and n > m
    if rect:
        benefit_nm = masked_rect_benefit(costs, maximize, row_mask, col_mask)
        oriented = (
            np.ascontiguousarray(np.swapaxes(benefit_nm, 1, 2))
            if transposed
            else benefit_nm
        )
    else:
        benefit_nm = oriented = masked_square_benefit(costs, maximize, row_mask, col_mask)
    ne, me = benefit_nm.shape[1:]
    rids = cids = None
    if tie_break:
        # identity-keyed perturbation: rank identities (not batch
        # positions) so a surviving (row, col) pair keeps its perturbed
        # cell when the batch or the identities inside it permute — the
        # fingerprint memo then still hits under tie-breaking.  Without
        # caller identities this degenerates bit-identically to the
        # positional ramp.
        if row_ids is not None or col_ids is not None:
            rids = _pad_ids(_as_id_matrix(row_ids, b, n, "row_ids"), ne)
            cids = _pad_ids(_as_id_matrix(col_ids, b, m, "col_ids"), me)
        benefit_nm, tb_scale = _tie_break_perturb(benefit_nm, rids, cids)
        oriented = (
            np.ascontiguousarray(np.swapaxes(benefit_nm, 1, 2))
            if transposed
            else benefit_nm
        )
        if tb_scale is not None and approx and eps_min is None:
            # resolve the perturbation: S * eps below the smallest gap
            # between distinct perturbed totals (>= tb_scale on the
            # integral quantum).  Deterministic in the shape alone, so
            # the context key stays stable across rounds.
            eps_min = tb_scale / (size + 1)
    r, c = oriented.shape[1:]

    # ---- context lookup: identity matching + memo + warm prices --------- #
    key = (context_key, backend, maximize, eps_min, tie_break)
    entry = None
    bits = None
    inst = None
    # the device is resolved only where one is needed: a context's tensors
    # or an auction solve (the exact backends alone run on the host)
    dev = context.device if context is not None else (
        resolve_device(device) if approx else None
    )
    ahead = None
    if context is not None:
        context.stats["solves"] += 1
        inst = _as_instance_ids(instance_ids, b)
        if rids is None:
            rids = _pad_ids(_as_id_matrix(row_ids, b, n, "row_ids"), ne)
            cids = _pad_ids(_as_id_matrix(col_ids, b, m, "col_ids"), me)
        cand = context.get(key)
        if cand is not None and cand.transposed == transposed and cand.rect == rect:
            entry = cand
        if approx and entry is not None and entry.used_fallback.any():
            # an instance whose last solve adopted the exact answer will
            # most likely again: start that re-solve now, on the host
            # worker, so it runs while the auction does
            old = _positions_in(inst[None], entry.instance_ids[None])[0]
            pred = np.nonzero(old >= 0)[0]
            pred = pred[entry.used_fallback[old[pred]]]
            if pred.size:
                ahead = _Ahead(_pick_exact() if rect else _pick_auto(size), oriented, pred)
        bits = torch.from_numpy(_f64_bits(benefit_nm)).to(dev)

    sp = stages.open("lap.identity", syncs=0)

    memo_b = np.zeros(b, bool)
    warm_result = np.zeros(b, bool)
    warm_solver = np.zeros(b, bool)
    lru_warm = np.zeros(b, bool)  # instances re-seeded from the departed LRU
    init_prices_full = None  # (B, C) device, assembled by column identity
    col_of_memo = None
    stale = None
    old_idx = row_pos_or = col_pos_or = None
    if entry is not None:
        b0 = entry.instance_ids.shape[0]
        # Device-resident identity matching: instance match, row/col
        # identity match and the exact fingerprint compare run on device
        # against the cached copies of last round's identities, and come
        # back in ONE transfer.
        inst_d, rids_d, cids_d = _ids_to_device(inst, rids, cids, dev)
        oi_d, rp_d, cp_d, ru_d = _match_prologue_dev(
            inst_d,
            entry.ids_dev[0],
            rids_d,
            entry.ids_dev[1],
            cids_d,
            entry.ids_dev[2],
            bits,
            entry.fp_bits,
        )
        packed = torch.cat([oi_d[:, None], rp_d, cp_d, ru_d.long()], dim=1).cpu().numpy()
        context.stats["host_syncs"] += 1
        old_idx = packed[:, 0]
        row_pos = packed[:, 1 : 1 + ne]
        col_pos = packed[:, 1 + ne : 1 + ne + me]
        row_unchanged = packed[:, 1 + ne + me :].astype(bool)
        matched = old_idx >= 0
        safe_b = np.clip(old_idx, 0, b0 - 1)
        ne0, me0 = entry.row_ids.shape[1], entry.col_ids.shape[1]
        rows_bij = matched & (ne == ne0) & (row_pos >= 0).all(axis=1)
        cols_bij = matched & (me == me0) & (col_pos >= 0).all(axis=1)
        memo_b = rows_bij & cols_bij & row_unchanged.all(axis=1)
        changed_any = ((row_pos >= 0) & ~row_unchanged).any(axis=1)
        warm_solver = matched & ~changed_any
        if not (approx and entry.prices is not None):
            # exact backends carry no prices: short of a memo hit nothing
            # is warm-STARTED, so neither the result flag nor the stats
            # may claim it (keeps warm-rate gates honest)
            warm_solver = np.zeros(b, bool)
        warm_result = memo_b | warm_solver

        if (
            memo_b.all()
            and np.array_equal(inst, entry.instance_ids)
            and np.array_equal(rids, entry.row_ids)
            and np.array_equal(cids, entry.col_ids)
        ):
            # Full-memo fast path: identical identities in identical
            # positions (the steady-state fan-out).  No remap, no price
            # re-assembly, and the stored entry (fingerprints, prices,
            # assignments) is still exactly right — nothing is re-stored.
            # This keeps the per-round cost of an unchanged 2048-GPU
            # fan-out at fingerprint-compare + readout.
            context.stats["memo_instances"] += b
            context.stats["warm_instances"] += b
            context.stats["memo_hits"] += 1
            sp.annotate(memo=b, warm=b)
            if ahead is not None:
                ahead.drop()
            stages.open("lap.check", syncs=0)
            col_of, total, _ = _extract(costs, entry.final_col_of, row_mask, col_mask)
            stages.close()
            return BatchedMatchResult(
                col_of,
                total,
                entry.converged.copy(),
                entry.used_fallback.copy(),
                backend,
                time.perf_counter() - t0,
                np.zeros(b, np.int64),
                warm_result,
                "rect" if rect else "square",
            )

        # oriented views of the identity maps (bidders are the short side)
        row_pos_or = col_pos if transposed else row_pos
        col_pos_or = row_pos if transposed else col_pos
        r0 = me0 if transposed else ne0
        c0 = ne0 if transposed else me0

        if memo_b.any():
            mb = np.nonzero(memo_b)[0]
            ob = old_idx[mb]
            # original-space remap: old assignment re-expressed in the new
            # row/col positions of the surviving identities
            rp_n = row_pos[mb][:, :n]
            oc_n = np.take_along_axis(entry.final_col_of[ob], rp_n, axis=1)
            inv_n = _invert_pos(col_pos[mb][:, :m], entry.real_shape[1])
            col_of_memo = np.where(
                oc_n >= 0,
                np.take_along_axis(inv_n, np.clip(oc_n, 0, None), axis=1),
                -1,
            )
        if approx and entry.prices is not None:
            # Price re-assembly by column identity: surviving columns carry
            # last round's price, new columns start cold.  A column whose
            # last-round owner row changed content or vanished is reset —
            # its price reflects competition that may no longer exist.
            if transposed:
                # original row i IS oriented column i: reset it directly
                stale = (col_pos_or >= 0) & ~row_unchanged
            else:
                survived = np.zeros((b, r0), bool)
                bb, rr = np.nonzero(row_pos_or >= 0)
                survived[bb, row_pos_or[bb, rr]] = row_unchanged[bb, rr]
                own = np.where(
                    col_pos_or >= 0,
                    np.take_along_axis(
                        entry.owner[safe_b], np.clip(col_pos_or, 0, None), axis=1
                    ),
                    -1,
                )
                stale = (own >= 0) & ~np.take_along_axis(
                    survived, np.clip(own, 0, None), axis=1
                )
            keep_host = matched[:, None] & (col_pos_or >= 0) & ~stale
            gathered = entry.prices[
                torch.from_numpy(safe_b).to(dev)[:, None],
                torch.from_numpy(np.clip(col_pos_or, 0, c0 - 1)).to(dev),
            ]
            # columns NOT carried over from last round may still have a
            # parked price from an earlier departure (demotion-resume):
            # seed them from the departed-identity LRU instead of zero.
            cold_seed = context.restore_departed(
                key[:2] + (transposed,), inst, rids if transposed else cids, ~keep_host
            )
            if cold_seed is not None:
                # a resumed instance restarts near its parked equilibrium:
                # skip the epsilon-scaling schedule (valid for ANY initial
                # prices — module docstring) but do NOT report it warm,
                # its content was never fingerprint-verified.
                lru_warm = (cold_seed != 0.0).any(axis=1)
            keep = torch.from_numpy(keep_host).to(dev)
            init_prices_full = torch.where(
                keep,
                gathered,
                0.0 if cold_seed is None else torch.from_numpy(cold_seed).to(dev),
            )
        context.stats["memo_instances"] += int(memo_b.sum())
        context.stats["warm_instances"] += int(warm_result.sum())
        context.stats["cold_instances"] += int(b - warm_result.sum())
        if memo_b.all():
            context.stats["memo_hits"] += 1
    elif context is not None:
        context.stats["cold_instances"] += b

    # ---- partial-batch compaction + primary solve ----------------------- #
    sidx = np.nonzero(~memo_b)[0]
    col_solve_full = np.full((b, r), -1, np.int64)
    converged = np.ones(b, bool)
    used_fallback = np.zeros(b, bool)
    bid_iters = np.zeros(b, np.int64)
    prices_sub = None
    if entry is not None and memo_b.any():
        mb = np.nonzero(memo_b)[0]
        ob = old_idx[mb]
        rp = row_pos_or[mb]
        oc = np.take_along_axis(entry.col_solve[ob], rp, axis=1)
        inv = _invert_pos(col_pos_or[mb], c0)
        col_solve_full[mb] = np.where(
            oc >= 0, np.take_along_axis(inv, np.clip(oc, 0, None), axis=1), -1
        )
        converged[mb] = entry.converged[ob]
        used_fallback[mb] = entry.used_fallback[ob]
        if sidx.size:
            context.stats["compacted_solves"] += 1
    if stale is not None:
        solve_mask = ~memo_b
        context.stats["rows_invalidated"] += int((stale & solve_mask[:, None]).sum())
    if traced:
        sp.annotate(memo=int(memo_b.sum()), warm=int(warm_result.sum()))

    if sidx.size:
        sp = stages.open("lap.run", instances=int(sidx.size), syncs=0)
        sub_ben = oriented[sidx]
        if approx:
            ip_sub = warm_sub = None
            if init_prices_full is not None:
                ip_sub = init_prices_full[torch.from_numpy(sidx).to(dev)]
                warm_sub = (warm_solver | lru_warm)[sidx]
            col_solve_sub, conv_sub, prices_sub, iters_sub = _run_auction(
                sub_ben,
                rect,
                eps_min,
                max_iters,
                use_kernel=(backend == "auction_kernel"),
                init_prices=ip_sub,
                warm=warm_sub,
                device=dev,
                span=sp,
            )
            col_solve_full[sidx] = col_solve_sub
            converged[sidx] = conv_sub
            bid_iters[sidx] = iters_sub
            if context is not None:
                context.stats["host_syncs"] += 1  # auction assignment readout
        else:
            col_solve_sub, conv_sub = _BACKENDS[backend](sub_ben, eps_min, max_iters)
            col_solve_full[sidx] = col_solve_sub
            converged[sidx] = conv_sub

    stages.open("lap.check", syncs=0)
    col_full = _to_orig_cols(col_solve_full, transposed, n, m)
    if col_of_memo is not None:
        # memoised instances reuse the FINAL cached assignment (which may
        # include an exact-fallback fix the raw solve state lacks); only
        # the real rows are written — square-embedded pad rows are sliced
        # off by _extract anyway
        mb = np.nonzero(memo_b)[0]
        col_full[mb[:, None], np.arange(n)[None, :]] = col_of_memo
    col_of, total, complete = _extract(costs, col_full, row_mask, col_mask)
    expect = _expected_cardinality(costs, row_mask, col_mask)
    solve_mask = ~memo_b
    needs_fallback = solve_mask & ((~converged) | (complete < expect))
    if approx and rect and prices_sub is not None:
        viol = np.zeros(b, bool)
        viol[sidx] = _rect_bound_violation(prices_sub, col_solve_full[sidx])
        needs_fallback |= viol
        if context is not None:
            context.stats["cert_violations"] += int(viol.sum())
            context.stats["host_syncs"] += 1  # certificate verdict readout
    if needs_fallback.any() and approx:
        fb = _pick_exact() if rect else _pick_auto(size)
        idx = np.nonzero(needs_fallback)[0]
        sp = stages.open("lap.fallback", instances=int(idx.size))
        if ahead is None:
            fb_solve, _ = _BACKENDS[fb](oriented[idx], None, None)
            n_ahead, wait_s = 0, 0.0
        else:
            fb_solve, n_ahead, wait_s = ahead.join(_BACKENDS[fb], oriented, idx)
            ahead = None
        sp.annotate(ahead=n_ahead, wait_ms=wait_s * 1e3)
        fb_res, fb_total, fb_complete = _extract(
            costs[idx],
            _to_orig_cols(fb_solve, transposed, n, m),
            None if row_mask is None else row_mask[idx],
            None if col_mask is None else col_mask[idx],
        )
        # Adopt the exact re-solve only where it actually improves the
        # result: a structurally infeasible instance (forbidden edges make
        # a complete matching impossible) trips the cardinality check on
        # every call, but if the auction already found an equally large,
        # equally good matching there is nothing to fix — and counting it
        # as a fallback would poison the auction-quality metric the
        # microbench records.
        if tie_break:
            # rank in PERTURBED benefit space: two original-optimal
            # assignments tie on original cost, but only the canonical
            # one wins the perturbed comparison — a fallback that found
            # it must displace a non-canonical primary result.
            improves = _benefit_total(benefit_nm[idx], fb_res) > _benefit_total(
                benefit_nm[idx], col_of[idx]
            )
        elif maximize:
            improves = fb_total > total[idx]
        else:
            improves = fb_total < total[idx]
        adopt = (fb_complete > complete[idx]) | (
            (fb_complete == complete[idx]) & improves
        )
        sel = idx[adopt]
        col_of[sel] = fb_res[adopt]
        total[sel] = fb_total[adopt]
        used_fallback[sel] = True
        sp.annotate(adopted=int(sel.size))
    if ahead is not None:
        ahead.drop()

    if context is not None:
        stages.open("lap.store", syncs=0)
        context.stats["bid_iters"] += int(bid_iters.sum())
        prices_full = None
        if approx:
            base = (
                init_prices_full
                if init_prices_full is not None
                else torch.zeros((b, c), dtype=torch.float32, device=dev)
            )
            if prices_sub is not None:
                base = base.index_copy(0, torch.from_numpy(sidx).to(dev), prices_sub)
            prices_full = base
            if rect:
                # Price repair before caching: a column with no owner is
                # available again next round, so its stale price is reset
                # to the cold-start level.  This keeps the stored prices
                # close to the all-equal-unassigned condition the
                # rectangular bound wants, so the next warm solve rarely
                # trips the certificate (which always runs on the *actual*
                # final prices, above).
                prices_full = torch.where(
                    torch.from_numpy(_assigned_cols(col_solve_full, c)).to(dev),
                    prices_full,
                    0.0,
                )
        owner = np.full((b, c), -1, np.int64)
        bb, rr = np.nonzero(col_solve_full >= 0)
        owner[bb, col_solve_full[bb, rr]] = rr
        context.store(
            key,
            _CtxEntry(
                instance_ids=inst,
                row_ids=np.ascontiguousarray(rids),
                col_ids=np.ascontiguousarray(cids),
                transposed=transposed,
                rect=rect,
                real_shape=(n, m),
                fp_bits=_bucketed_bits(bits),
                prices=prices_full,
                owner=owner,
                col_solve=col_solve_full,
                final_col_of=col_of.copy(),
                converged=converged.copy(),
                used_fallback=used_fallback.copy(),
                ids_dev=_ids_to_device(inst, rids, cids, dev),
            ),
        )
        stages.close()

    return BatchedMatchResult(
        col_of,
        total,
        converged,
        used_fallback,
        backend,
        time.perf_counter() - t0,
        bid_iters,
        warm_result,
        "rect" if rect else "square",
    )


def _to_orig_cols(
    col_solve: np.ndarray, transposed: bool, n: int, m: int
) -> np.ndarray:
    """Map solve-space assignments back to original row space.

    ``col_solve`` is (B, R) over the oriented instance.  Untransposed
    solves already index original columns; transposed (n > m rectangular)
    solves assign original *rows* to the m bidding columns and must be
    inverted (vectorised scatter)."""
    if not transposed:
        return col_solve
    b = col_solve.shape[0]
    col_of = np.full((b, n), -1, np.int64)
    bb, jj = np.nonzero((col_solve >= 0) & (col_solve < n))
    col_of[bb, col_solve[bb, jj]] = jj
    return col_of


def _extract(costs, col_of_sq, row_mask, col_mask):
    """Map solver assignments back to the original instances."""
    b, n, m = costs.shape
    cols = col_of_sq[:, :n].astype(np.int64)  # ignore padded rows
    valid = (cols >= 0) & (cols < m)
    safe = np.where(valid, cols, 0)
    picked = np.take_along_axis(costs, safe[:, :, None], axis=2)[:, :, 0]
    valid &= np.isfinite(picked)
    if row_mask is not None:
        valid &= np.asarray(row_mask, bool)
    if col_mask is not None:
        valid &= np.take_along_axis(np.asarray(col_mask, bool), safe, axis=1)
    col_of = np.where(valid, cols, -1)
    total = np.where(valid, picked, 0.0).sum(axis=1)
    return col_of, total, valid.sum(axis=1)


def _expected_cardinality(costs, row_mask, col_mask):
    b, n, m = costs.shape
    nr = np.full(b, n) if row_mask is None else np.asarray(row_mask, bool).sum(1)
    nc = np.full(b, m) if col_mask is None else np.asarray(col_mask, bool).sum(1)
    return np.minimum(nr, nc)


def solve_lap(
    cost: np.ndarray,
    maximize: bool = False,
    backend: str = "auto",
    context: Optional[MatchContext] = None,
    context_key: str = "default",
    row_ids: Optional[np.ndarray] = None,
    col_ids: Optional[np.ndarray] = None,
    tie_break: bool = False,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-instance LAP with the same backend knob as the batched engine.

    Drop-in superset of ``hungarian.solve_lap``: without a ``context``,
    ``auto``/``numpy``/``scipy`` keep the original exact dispatch (no
    embedding overhead) and the auction backends route through the batched
    engine.  With a ``context``, EVERY backend routes through the engine so
    identical consecutive solves memo-hit and the auction carries prices;
    ``row_ids``/``col_ids`` key that state by identity (e.g. node ids for
    the final migration match).  ``tie_break`` always routes through the
    engine (the canonical perturbation must apply).  Returns scipy-style
    ``(row_ind, col_ind)``.
    """
    if context is None and not tie_break and backend in ("auto", "numpy", "scipy"):
        return hungarian.solve_lap(cost, maximize=maximize, backend=backend)
    res = solve_lap_batched(
        np.asarray(cost)[None],
        maximize=maximize,
        backend=backend,
        context=context,
        context_key=context_key,
        row_ids=row_ids,
        col_ids=col_ids,
        tie_break=tie_break,
        device=device,
    )
    return res.pairs(0)
