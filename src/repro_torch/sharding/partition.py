"""Mesh-axis helpers over a torch ``DeviceMesh`` with named dims.

The PyTorch counterpart of ``src/repro/sharding/partition.py``.  A spec is
kept in the form of JAX's ``PartitionSpec``, a tuple with one entry per
tensor dim: a mesh axis name, a tuple of names, or ``None``.  :func:`named`
turns it into DTensor placements, one per *mesh* dim: ``Shard(d)`` where
tensor dim ``d`` names that mesh dim, else ``Replicate()``.  An entry
``("pod", "data")`` shards its tensor dim over both mesh dims in mesh order,
which is JAX's major-to-minor order.

A production mesh needs no 256 devices: ``launch/mesh.make_mesh`` builds
its ``DeviceMesh`` on a fake process group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from torch.distributed.tensor import Replicate, Shard


def axis_names(mesh) -> tuple:
    """The mesh's axis names, major to minor."""
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}``, as JAX's ``mesh.shape``."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def data_axes(mesh) -> tuple:
    """All batch-parallel axes: ('pod', 'data') on multi-pod, ('data',) else."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def axis_size(mesh, axes) -> int:
    """The product of the sizes of ``axes`` (a name, a tuple of names, or
    ``None``)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def named(mesh, spec: tuple) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    owner = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            owner[a] = dim
    names = axis_names(mesh)
    unknown = set(owner) - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} not in "
                         f"the mesh's {names}")
    return [Shard(owner[a]) if a in owner else Replicate() for a in names]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as JAX's ``NamedSharding``; ``placements`` are the
    DTensor placements that ``distribute_tensor`` takes.  An entry naming
    one axis in a tuple is kept as the name alone, as ``PartitionSpec``
    keeps it."""
    mesh: object
    spec: tuple

    def __post_init__(self):
        object.__setattr__(self, "spec", tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in self.spec))

    @property
    def placements(self) -> list:
        return named(self.mesh, self.spec)
