"""Partition specs and their DTensor placements.

:class:`PartitionSpec` is the counterpart of ``jax.sharding.PartitionSpec``:
one entry per tensor dimension, each ``None`` (replicated), a mesh axis
name, or a tuple of names (the dimension split over each, the first the
major).  It is a leaf of the port's trees (not a tuple, which
``repro_torch.tree`` walks into).  :func:`spec_placements` turns a spec
into the ``Shard``/``Replicate`` placement of each mesh dimension: the
counterpart of ``NamedSharding``, with its legality checks.  A mesh axis
of size 1 splits nothing, so its placement is ``Replicate`` (as the
rules engine replicates over it): on the card's (1, 1) mesh every tensor
is a replica, which DTensor's view ops take in every release.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import mesh_shape

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec:
    __slots__ = ("parts",)

    def __init__(self, *parts: MeshAxes):
        self.parts = tuple(tuple(p) if isinstance(p, list) else p for p in parts)

    def __iter__(self) -> Iterator[MeshAxes]:
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.parts!r}"


def spec_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, axes: MeshAxes) -> int:
    """Ranks along a spec entry's mesh axes (1 for None)."""
    shape = mesh_shape(mesh)
    size = 1
    for a in spec_axes(axes):
        size *= shape[a]
    return size


def spec_placements(spec: PartitionSpec, mesh) -> list:
    """One placement per mesh dimension: ``Shard(d)`` where the spec puts
    that mesh axis (of more than one rank) on tensor dimension ``d``, else
    ``Replicate()``.  An axis the mesh lacks, an axis used twice, or a
    tuple of axes out of the mesh's order raises (DTensor splits a
    dimension over several mesh dimensions in mesh order)."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    where = {}
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        order = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: mesh {names} has no axis {a!r}")
            if a in where:
                raise ValueError(f"{spec}: mesh axis {a!r} used twice")
            where[a] = d
            order.append(names.index(a))
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {axes} out of the mesh's order {names}")
    return [Shard(where[a]) if a in where and sizes[a] > 1 else Replicate() for a in names]
