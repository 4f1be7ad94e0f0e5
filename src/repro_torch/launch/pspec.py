"""Logical-axis sharding: model code names axes, the launcher maps them.

PyTorch counterpart of the JAX package's ``launch/pspec.py``.  A
:class:`ShardingRules` maps *logical* axis names ("batch", "heads", ...) to
the physical axes of a :class:`repro_torch.launch.mesh.Mesh` (or None), and
``spec_for`` gives the partition spec of one array: a tuple with one entry
per dim, each a mesh axis name, a tuple of names or None, the form of a
``jax.sharding.PartitionSpec``.  ``sharding_for`` pairs it with its mesh
(:class:`NamedSharding`).

Divisibility-safe: a logical axis is only sharded if its size divides the
mesh-axis extent (e.g. qwen2-vl's 12 heads are NOT sharded over a 16-way
model axis; its 8960-wide FFN is), and a mesh axis is used at most once per
spec.

The reference's model code calls ``constrain(x, "batch", "seq", "embed")``,
a sharding constraint under the rules the launcher installs (``use_rules``)
and a no-op outside.  One card has no mesh to constrain to: the port's
model code does not call it, and here it returns its input, after checking
inside a rules context that one logical axis is named per dim.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import Mesh

AxisName = Union[str, Tuple[str, ...], None]
#: one entry per dim, as a ``jax.sharding.PartitionSpec`` holds them
PartitionSpec = Tuple[AxisName, ...]

#: default logical -> physical mapping for the production mesh.
#: "dp" expands to ("pod", "data") when a pod axis exists.
DEFAULT_RULES: Dict[str, AxisName] = {
    "batch": "dp",
    "seq": None,
    "embed": None,
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "expert": "model",
    "expert_ff": None,
    "fsdp": "dp",      # weight dim sharded ZeRO-3 style over the data axis
    "heads_flat": "model",  # flattened H*head_dim dim (wo input)
    "ssm_inner": "model",   # mamba d_inner projections
    "ssm_heads": "model",   # mamba recurrent-state heads
    "layers": None,
    "state": None,
    "cache_seq": None,  # decode KV-cache sequence axis (context parallel)
    #: MoE dispatch buffers (E, C, D): experts over "model", capacity over
    #: the data axes, so no device computes the full capacity of its
    #: expert shard
    "capacity": "dp",
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh (``jax.sharding.NamedSharding``'s two
    fields)."""

    mesh: Mesh
    spec: PartitionSpec


class ShardingRules:
    def __init__(
        self,
        mesh: Mesh,
        rules: Optional[Dict[str, AxisName]] = None,
        dp_axes: Tuple[str, ...] = ("data",),
    ):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.dp_axes = dp_axes

    def _physical(self, logical: str) -> AxisName:
        phys = self.rules.get(logical)
        if phys == "dp":
            return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]
        return phys

    def axis_size(self, phys: AxisName) -> int:
        if phys is None:
            return 1
        if isinstance(phys, tuple):
            out = 1
            for a in phys:
                out *= self.mesh.shape[a]
            return out
        return self.mesh.shape[phys]

    def spec_for(self, dim_sizes: Sequence[int], logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        parts = []
        used: set = set()
        for size, name in zip(dim_sizes, logical_axes):
            if name is None:
                parts.append(None)
                continue
            phys = self._physical(name)
            names = phys if isinstance(phys, tuple) else (phys,) if phys else ()
            # a mesh axis may appear at most once per spec: first dim wins
            # (e.g. seq-parallel "seq"->model beats "heads"->model inside one
            # activation, because it comes first in the constrain() call)
            if (
                phys is None
                or size % self.axis_size(phys) != 0
                or any(n in used for n in names)
            ):
                parts.append(None)
            else:
                parts.append(phys)
                used.update(names)
        return tuple(parts)

    def sharding_for(self, dim_sizes, logical_axes) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(dim_sizes, logical_axes))


_state = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def constrain(x, *logical_axes: Optional[str]):
    """``x`` itself; inside a rules context, after checking that one logical
    axis is named per dim (the reference's check before its sharding
    constraint)."""
    rules = current_rules()
    if rules is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"constrain: {len(logical_axes)} axes for rank-{x.ndim} array"
        )
    return x
