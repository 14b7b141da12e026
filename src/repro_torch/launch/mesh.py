"""Device meshes (counterpart of the reference package's ``launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, built over the process group the caller has already
initialised (``torch.distributed.init_process_group``, with its address,
world size and rank given explicitly).  Functions, never module-level
meshes, so importing this module touches no device and no process group.

The mesh's size must equal the world size: a mesh shape that does not
match raises, and no smaller mesh is built instead.  The card's machine
has one H100, so on it the only mesh is ``(1, 1)`` over NCCL; meshes of
several ranks run on the CPU over gloo (the tests), or over the fake
backend of ``torch.testing`` for shape-only checks of the 512-rank
production layout.

Target hardware: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit; the
rates are NVIDIA's data-sheet figures for that part (dense, no
sparsity).  HBM capacity is read from the card itself (:func:`hbm_bytes`);
where no card is present the data sheet's 80 GB stands in.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device

H100 = {
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "peak_flops": 989e12,  # bf16 FLOP/s, dense, on the tensor cores
    "peak_flops_tf32": 495e12,
    "peak_flops_fp32": 67e12,  # outside the tensor cores
    "hbm_bw": 3.35e12,  # B/s
    "nvlink_bw": 900e9,  # B/s per card, both directions, all 18 links
    "hbm_bytes": 80 * 10 ** 9,  # the data sheet's 80 GB; hbm_bytes() reads the card's own
}

MeshLike = Union[DeviceMesh, Mapping[str, int]]


def hbm_bytes(device=None) -> int:
    """The card's memory in bytes, as CUDA reports it."""
    return torch.cuda.get_device_properties(resolve_device(device)).total_memory


def _make(shape: Sequence[int], axes: Sequence[str], device) -> DeviceMesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} holds {n} ranks, the world has {world}")
    dev = resolve_device(device).type
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device=None) -> DeviceMesh:
    """A small mesh over the initialised group (the tests' gloo ranks)."""
    return _make(shape, axes, device)


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (or of a mapping, returned as a
    dict): what the sharding rules read, as the reference's read
    ``mesh.shape``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def dp_axes(mesh: MeshLike) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def n_chips(mesh: MeshLike) -> int:
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n
