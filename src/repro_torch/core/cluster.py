"""Cluster topology and placement-plan representation.

A placement plan is the object the paper's Algorithms 2/3/5 operate on:
which job(s) sit on every GPU of every node.  We represent it densely as an
int array

    ``slots[node, gpu_in_node, pack_slot] = job_id`` (``-1`` = empty)

with ``pack_slot < MAX_PACK = 2`` because "Tesserae imposes a limit of two
models running simultaneously on each GPU" (§5).

GPUs are homogeneous within a cluster by default (§4.1 assumption).  The
workload scenario lab extends the spec with OPT-IN heterogeneity:
``node_gpu_types`` gives every node its own GPU type (A100 vs V100 mixes,
Fig. 12b / Gavel's heterogeneity regime) and ``nodes_per_rack`` imposes a
rack/pod topology.  Both default to off, in which case every code path
that consults them is bit-for-bit the homogeneous seed behaviour —
placement, migration and packing only become type/topology-aware when a
scenario asks for it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import numpy as np

MAX_PACK = 2
EMPTY = -1


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    num_nodes: int
    gpus_per_node: int
    #: label only (profiles key off it): "a100", "v100", "tpu-v5e", ...
    gpu_type: str = "a100"
    #: OPT-IN per-node GPU types (len == num_nodes).  ``None`` (default) =
    #: homogeneous cluster of ``gpu_type`` — the seed semantics, where the
    #: profile alone decides throughput.  When set, the cluster is the
    #: authority: schedulers/simulators derive per-node profiles from it.
    node_gpu_types: Optional[Tuple[str, ...]] = None
    #: OPT-IN rack topology: nodes [k*r, (k+1)*r) form rack k.  ``0``
    #: (default) = topology-unaware (single rack, no locality terms).
    nodes_per_rack: int = 0

    def __post_init__(self):
        if self.node_gpu_types is not None:
            types = tuple(self.node_gpu_types)
            object.__setattr__(self, "node_gpu_types", types)
            if len(types) != self.num_nodes:
                raise ValueError(
                    f"node_gpu_types has {len(types)} entries for "
                    f"{self.num_nodes} nodes"
                )
        if self.nodes_per_rack < 0:
            raise ValueError("nodes_per_rack must be >= 0")

    @property
    def num_gpus(self) -> int:
        return self.num_nodes * self.gpus_per_node

    def gpu_id(self, node: int, local: int) -> int:
        return node * self.gpus_per_node + local

    def node_of(self, gpu_id: int) -> int:
        return gpu_id // self.gpus_per_node

    def local_of(self, gpu_id: int) -> int:
        return gpu_id % self.gpus_per_node

    # -- heterogeneity / topology (all trivially constant when disabled) -- #
    @property
    def is_heterogeneous(self) -> bool:
        """True iff at least two nodes carry different GPU types."""
        return self.node_gpu_types is not None and len(set(self.node_gpu_types)) > 1

    @property
    def has_topology(self) -> bool:
        """True iff the rack structure partitions the nodes non-trivially."""
        return 0 < self.nodes_per_rack < self.num_nodes

    def gpu_type_of(self, node: int) -> str:
        return (
            self.gpu_type
            if self.node_gpu_types is None
            else self.node_gpu_types[node]
        )

    def node_types(self) -> Tuple[str, ...]:
        """Per-node GPU types, materialised even for homogeneous clusters."""
        return self.node_gpu_types or (self.gpu_type,) * self.num_nodes

    def rack_of(self, node: int) -> int:
        return 0 if self.nodes_per_rack <= 0 else node // self.nodes_per_rack

    @property
    def num_racks(self) -> int:
        if not self.has_topology:
            return 1
        return -(-self.num_nodes // self.nodes_per_rack)


class ClusterHealth:
    """Mutable per-node health state (the fault-injection layer's view of
    the cluster).

    ``up[k]`` — node k accepts placements; a down node is ZERO capacity
    for the scheduler (placement skips it, migration relabelling is
    penalised off it).  ``speed_factor[k]`` — the node's GPUs run at this
    fraction of nominal speed (gpu-degrade events; a health-aware
    scheduler drains jobs off such nodes via the relabelling benefit).
    ``outages`` counts node-down events observed so far; it feeds the
    pooled empirical MTBF estimate behind MTBF-aware consolidation
    (failure-aware policies spread large gangs across racks only when the
    outage process is measurably hot).  A freshly constructed health
    object is all-up / full-speed / zero-outage — every consumer treats
    that state bit-identically to "no health tracking at all" (the seed
    path).
    """

    def __init__(self, num_nodes: int):
        self.up = np.ones(num_nodes, dtype=bool)
        self.speed_factor = np.ones(num_nodes, dtype=np.float64)
        self.outages = 0

    @property
    def all_up(self) -> bool:
        return bool(self.up.all())

    @property
    def degraded(self) -> bool:
        """True iff any node runs below nominal speed."""
        return bool((self.speed_factor != 1.0).any())

    def down_nodes(self) -> np.ndarray:
        """Indices of nodes currently down (sorted ascending)."""
        return np.nonzero(~self.up)[0]

    def note_outage(self) -> None:
        """Record one node-down event (feeds :meth:`empirical_mtbf_s`)."""
        self.outages += 1

    def empirical_mtbf_s(self, now: float) -> Optional[float]:
        """Pooled per-node MTBF estimate from the applied outage stream.

        ``num_nodes * elapsed / outages`` — the maximum-likelihood rate for
        a homogeneous Poisson outage process observed over all nodes.
        ``None`` until the first outage (no evidence the process exists).
        """
        if self.outages <= 0:
            return None
        elapsed = max(float(now), 1.0)
        return elapsed * self.up.shape[0] / self.outages

    def hazard_hot(self, now: float, threshold_s: float) -> bool:
        """True iff the observed outage process is hot enough (empirical
        per-node MTBF below ``threshold_s``) to justify spreading large
        gangs across failure domains."""
        mtbf = self.empirical_mtbf_s(now)
        return mtbf is not None and mtbf < threshold_s

    def copy(self) -> "ClusterHealth":
        out = ClusterHealth(self.up.shape[0])
        out.up = self.up.copy()
        out.speed_factor = self.speed_factor.copy()
        out.outages = self.outages
        return out


class PlacementPlan:
    """Dense job-on-GPU map with set-style helpers used by the matchers."""

    def __init__(self, cluster: ClusterSpec, slots: np.ndarray | None = None):
        self.cluster = cluster
        if slots is None:
            slots = np.full(
                (cluster.num_nodes, cluster.gpus_per_node, MAX_PACK),
                EMPTY,
                dtype=np.int64,
            )
        expected = (cluster.num_nodes, cluster.gpus_per_node, MAX_PACK)
        if slots.shape != expected:
            raise ValueError(f"slots shape {slots.shape} != {expected}")
        self.slots = slots

    # ------------------------------------------------------------------ #
    def copy(self) -> "PlacementPlan":
        return PlacementPlan(self.cluster, self.slots.copy())

    def jobs_on_gpu(self, node: int, local: int) -> Tuple[int, ...]:
        js = self.slots[node, local]
        return tuple(int(j) for j in js if j != EMPTY)

    def job_ids(self) -> FrozenSet[int]:
        flat = self.slots[self.slots != EMPTY]
        return frozenset(int(j) for j in flat)

    def gpus_of_job(self, job_id: int) -> FrozenSet[int]:
        nodes, locals_, _ = np.nonzero(self.slots == job_id)
        return frozenset(
            self.cluster.gpu_id(int(n), int(l)) for n, l in zip(nodes, locals_)
        )

    def job_gpu_map(self) -> Dict[int, FrozenSet[int]]:
        out: Dict[int, set] = {}
        nodes, locals_, packs = np.nonzero(self.slots != EMPTY)
        for n, l, p in zip(nodes, locals_, packs):
            j = int(self.slots[n, l, p])
            out.setdefault(j, set()).add(self.cluster.gpu_id(int(n), int(l)))
        return {j: frozenset(g) for j, g in out.items()}

    def free_gpus_per_node(self) -> np.ndarray:
        """Number of completely empty GPUs on each node."""
        empty = (self.slots == EMPTY).all(axis=-1)
        return empty.sum(axis=-1)

    def pack_capacity(self, node: int, local: int) -> int:
        return int((self.slots[node, local] == EMPTY).sum())

    def place_job(self, job_id: int, gpu_ids: Iterable[int]) -> None:
        for g in gpu_ids:
            n, l = self.cluster.node_of(g), self.cluster.local_of(g)
            row = self.slots[n, l]
            free = np.nonzero(row == EMPTY)[0]
            if len(free) == 0:
                raise ValueError(f"GPU {g} already holds {MAX_PACK} jobs")
            row[free[0]] = job_id

    def remove_job(self, job_id: int) -> None:
        self.slots[self.slots == job_id] = EMPTY

    def without_jobs(self, drop: Iterable[int]) -> "PlacementPlan":
        out = self.copy()
        for j in drop:
            out.remove_job(j)
        return out

    def restricted_to(self, keep: Iterable[int]) -> "PlacementPlan":
        keep = set(keep)
        out = self.copy()
        mask = ~np.isin(out.slots, list(keep)) & (out.slots != EMPTY)
        out.slots[mask] = EMPTY
        return out

    def is_consolidated(self, job_id: int) -> bool:
        """True if the job occupies one node, or whole nodes only."""
        nodes, locals_, _ = np.nonzero(self.slots == job_id)
        if len(nodes) == 0:
            return True
        unique_nodes = np.unique(nodes)
        if len(unique_nodes) == 1:
            return True
        # multi-node: every touched node must be fully covered by this job
        for n in unique_nodes:
            covered = np.unique(locals_[nodes == n])
            if len(covered) != self.cluster.gpus_per_node:
                return False
        return True

    def __eq__(self, other) -> bool:  # slot-order-insensitive equality
        if not isinstance(other, PlacementPlan):
            return NotImplemented
        return self.job_gpu_map() == other.job_gpu_map()

    def __repr__(self) -> str:
        rows: List[str] = []
        for n in range(self.cluster.num_nodes):
            cells = []
            for l in range(self.cluster.gpus_per_node):
                js = self.jobs_on_gpu(n, l)
                cells.append("+".join(map(str, js)) if js else ".")
            rows.append(f"node{n}[{' '.join(cells)}]")
        return "Placement(" + " | ".join(rows) + ")"


def count_migrations(
    prev: PlacementPlan,
    new: PlacementPlan,
    num_gpus_of: Dict[int, int] | None = None,
) -> int:
    """Definition 1: a job migrated iff present in both rounds with a
    different physical GPU set."""
    prev_map = prev.job_gpu_map()
    new_map = new.job_gpu_map()
    common = set(prev_map) & set(new_map)
    return sum(1 for j in common if prev_map[j] != new_map[j])
