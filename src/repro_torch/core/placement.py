"""Allocation without packing (Listing 1 lines 5-12, Fig. 5).

Given the priority-sorted active jobs, place as many as possible on empty
GPUs subject to **consolidated placement**:

* a job needing ``g <= gpus_per_node`` GPUs must get all of them on one
  node (best-fit: the node with the fewest free GPUs that still fits, to
  keep large holes open for large jobs);
* a job needing ``g > gpus_per_node`` GPUs must get whole nodes.

Placement can fail (line 8) when no consolidated hole exists even if the
total free GPU count suffices — those jobs go to ``pending_jobs`` and
become packing candidates (Algorithm 4).

On **heterogeneous** clusters the best-fit key additionally carries a
type-affinity term (``type_affinity=True``): sub-node jobs prefer the
SLOWEST GPU type that still fits before tie-breaking on hole size, and
multi-node gangs take the fastest empty nodes.  Without it, a 1-GPU job
arriving first can squat an A100 node while an 8-GPU gang lands on V100s
— the type-blindness bug; the affinity key is the minimal fix (the full
Gavel policy-as-optimization treatment stays future work).  On
homogeneous clusters every speed ties and the order degenerates
bit-identically to the seed best-fit.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import EMPTY, ClusterSpec, PlacementPlan
from repro_torch.core.jobs import JobState
from repro_torch.core.profiler import GPU_TYPES


def _node_speeds(cluster: ClusterSpec) -> Optional[np.ndarray]:
    """Per-node relative GPU speed, or None when every node ties (the
    homogeneous fast path — no key change at all)."""
    if not cluster.is_heterogeneous:
        return None
    return np.array([GPU_TYPES[t].speed for t in cluster.node_types()])


def place_without_packing(
    cluster: ClusterSpec,
    sorted_jobs: Sequence[JobState],
    type_affinity: bool = True,
    down_nodes: Optional[Iterable[int]] = None,
    spread_domains: bool = False,
) -> Tuple[PlacementPlan, List[JobState], List[JobState]]:
    """Greedy consolidated placement of priority-sorted jobs.

    Returns ``(plan, placed_jobs, pending_jobs)``.  Mirrors Listing 1: we
    keep walking the priority list while any GPU remains free, so a small
    job can fill a hole a larger, higher-priority job could not use.
    ``down_nodes`` are zero capacity: no hole on them is ever considered,
    so a down node's logical rows stay empty in the returned plan.
    ``spread_domains`` (failure-aware policies, racked clusters only)
    reorders each multi-node gang's candidate empty nodes breadth-first
    across racks, so a gang spans the maximum number of failure domains a
    single outage can only clip — instead of the default packing order
    that concentrates it in one rack.  Off (default) = seed behaviour.
    """
    plan = PlacementPlan(cluster)
    placed: List[JobState] = []
    pending: List[JobState] = []
    free_per_node = np.full(cluster.num_nodes, cluster.gpus_per_node, np.int64)
    if down_nodes is not None:
        for n in down_nodes:
            free_per_node[int(n)] = 0
    gpn = cluster.gpus_per_node
    speeds = _node_speeds(cluster) if type_affinity else None

    for job in sorted_jobs:
        g = job.num_gpus
        if free_per_node.sum() <= 0:
            pending.append(job)
            continue
        if g <= gpn:
            candidates = np.nonzero(free_per_node >= g)[0]
            if len(candidates) == 0:
                pending.append(job)
                continue
            if speeds is None:
                # best fit: smallest adequate hole (first index on ties)
                node = int(candidates[np.argmin(free_per_node[candidates])])
            else:
                # type-affinity best fit: the job runs at its node's
                # speed, so break hole-size ties toward the FASTEST type
                # (explicitly — not via the index-order accident) while
                # still filling partial holes before opening empty nodes
                order = np.lexsort(
                    (candidates, -speeds[candidates], free_per_node[candidates])
                )
                node = int(candidates[order[0]])
            gpus = _take_free_gpus(plan, node, g)
        else:
            if g % gpn != 0:
                raise ValueError(
                    f"job {job.job_id}: {g} GPUs not a multiple of node size {gpn}"
                )
            need_nodes = g // gpn
            empty_nodes = np.nonzero(free_per_node == gpn)[0]
            if len(empty_nodes) < need_nodes:
                pending.append(job)
                continue
            if speeds is not None and len(empty_nodes) >= need_nodes:
                # a gang runs at the pace of its SLOWEST node, so a
                # type-mixed gang throttles every fast GPU it holds to
                # the slow type's speed (the squat bug's worst case).
                # Prefer a type-PURE node set — fastest pure type first —
                # and fall back to the maximum-min-speed mixed set only
                # when no single type has enough empty nodes.
                esp = speeds[empty_nodes]
                pure = None
                for sp in sorted(set(esp.tolist()), reverse=True):
                    ns = empty_nodes[esp == sp]
                    if len(ns) >= need_nodes:
                        pure = ns
                        break
                empty_nodes = (
                    pure
                    if pure is not None
                    else empty_nodes[np.lexsort((empty_nodes, -esp))]
                )
            if spread_domains and cluster.has_topology and need_nodes > 1:
                # breadth-first across racks: take each rack's first empty
                # node before any rack's second, preserving the incoming
                # order (type-pure / best-speed) within each rack, so the
                # prefix empty_nodes[:need_nodes] spans max failure domains
                racks = np.array(
                    [cluster.rack_of(int(n)) for n in empty_nodes]
                )
                within = np.zeros(len(empty_nodes), dtype=np.int64)
                seen: Dict[int, int] = {}
                for i, r in enumerate(racks.tolist()):
                    within[i] = seen.get(r, 0)
                    seen[r] = within[i] + 1
                order = np.lexsort((np.arange(len(empty_nodes)), racks, within))
                empty_nodes = empty_nodes[order]
            gpus = []
            for node in empty_nodes[:need_nodes]:
                gpus.extend(_take_free_gpus(plan, int(node), gpn))
        plan.place_job(job.job_id, gpus)
        for gid in gpus:
            free_per_node[cluster.node_of(gid)] -= 1
        placed.append(job)
    return plan, placed, pending


def _take_free_gpus(plan: PlacementPlan, node: int, count: int) -> List[int]:
    cluster = plan.cluster
    out: List[int] = []
    for local in range(cluster.gpus_per_node):
        if (plan.slots[node, local] == EMPTY).all():
            out.append(cluster.gpu_id(node, local))
            if len(out) == count:
                return out
    raise RuntimeError(f"node {node} lacks {count} free GPUs")  # pragma: no cover


def apply_packing(
    plan: PlacementPlan,
    matches: Dict[int, int],
    placed_lookup: Dict[int, JobState],
) -> PlacementPlan:
    """Overlay pending jobs onto their matched placed jobs' GPUs."""
    out = plan.copy()
    for pending_id, placed_id in matches.items():
        gpus = out.gpus_of_job(placed_id)
        out.place_job(pending_id, gpus)
    return out
