"""The production mesh, carried over from the reference as shapes.

PyTorch counterpart of the JAX package's ``launch/mesh.py``.  There the
meshes are ``jax.make_mesh`` meshes of the reference's pod layout: one pod
of 16 x 16 devices on the axes ``(data, model)``, or two such pods with a
leading ``pod`` axis.  The port has no ``jax.sharding`` and one card has no
such mesh, so here a mesh is a description: its axis names and their sizes,
with no devices, no process group and no ``torch.distributed``.  It is what
:class:`repro_torch.launch.pspec.ShardingRules` and
:func:`repro_torch.launch.specs.bytes_per_device` read, ``mesh.shape[axis]``
and ``mesh.axis_names``, as they read a ``jax.sharding.Mesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh: {len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """The description ``jax.make_mesh(shape, axes)`` would build devices for."""
    return Mesh(tuple(axes), tuple(int(n) for n in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 devices (data, model).  Multi-pod: 2 pods of
    256 = 512 devices with a leading "pod" axis (data-parallel across the
    pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def dp_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """Names of the data-parallel axes (pod included when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_smoke_mesh() -> Mesh:
    """The 1-device mesh of the reference's CPU smoke runs."""
    return make_mesh((1, 1), ("data", "model"))
