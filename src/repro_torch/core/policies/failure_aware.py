"""Failure-aware policy wrapper (MTBF-aware consolidation, sort-key side).

Wraps any base policy and appends a domain-spread term to its sort key:
when the scheduler observes a HOT outage process (empirical per-node MTBF
from the applied ``FailureEvent`` stream below its ``spread_mtbf_h``
threshold — see ``ClusterHealth.hazard_hot``), multi-node gangs are
boosted ahead of their queue peers so they get first pick of the empty
nodes, which the placement stage then spreads breadth-first across racks
(``place_without_packing(spread_domains=True)``).  A single rack outage
then clips one node's worth of a large gang instead of killing the whole
thing's consolidated placement.

When the process is cold (or health tracking is off) the appended term is
a constant, so the wrapped order is IDENTICAL to the inner policy's —
clean traces, and degraded-but-not-failing clusters, see the seed order
bit-for-bit.  The scheduler drives the hot flag each round through
:meth:`set_spread_hot`; the wrapper never reads the clock itself, keeping
the policy pure and replay-deterministic.
"""

from __future__ import annotations

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.jobs import JobState
from repro_torch.core.policies.base import SchedulingPolicy


class FailureAwarePolicy(SchedulingPolicy):
    """Decorates ``inner`` with the hot-outage gang-spread boost."""

    def __init__(self, inner: SchedulingPolicy):
        super().__init__(inner.profile)
        self.inner = inner
        self.name = inner.name + "-fa"
        self._spread_hot = False

    def set_spread_hot(self, hot: bool) -> None:
        """Scheduler hook: called once per decide() with the current
        empirical-hazard verdict."""
        self._spread_hot = bool(hot)

    def sort_key(self, job: JobState, now: float, cluster: ClusterSpec):
        key = self.inner.sort_key(job, now, cluster)
        if not self._spread_hot:
            # constant append: preserves the inner order exactly
            return (key, 1)
        # hot outage process: multi-node gangs first within the inner
        # ordering tier would break the inner policy's fairness — instead
        # the boost is SUBORDINATE to the inner key (same tuple position),
        # so equal-priority jobs reorder gang-first but queue discipline
        # is untouched.
        is_gang = job.num_gpus > cluster.gpus_per_node
        return (key, 0 if is_gang else 1)
