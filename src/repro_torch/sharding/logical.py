"""Logical-axis activation sharding (counterpart of the reference
package's ``sharding/logical.py``).

Model code annotates activations with *logical* axis names
(``shard(x, "batch", "seq", "heads", "head_dim")``); a rule set maps
logical names to mesh axes (or ``None`` = replicated).  Outside a rule
context the annotations are no-ops (``shard`` returns ``x`` itself), so
the same model code runs on plain tensors on one device unchanged.

Inside :func:`axis_rules` the model runs on ``DTensor``s over the
context's ``DeviceMesh``: ``shard`` redistributes its argument to the
placements the rules give (GSPMD's ``with_sharding_constraint`` in the
reference, made explicit), replicating a dimension that is too small for
its mesh axes or does not divide them, as the reference does.  DTensor
refuses an op that mixes a plain tensor with a DTensor, so the tensors
the model makes itself (positions, masks, RoPE tables) go through
:func:`on_mesh`, which replicates them on the mesh of the DTensor they
meet.  Kernel wrappers hand DTensors to their kernels through
:func:`local_call` (``local_map``), each rank's kernel on its local shard.

Rule sets are plain dicts; :func:`train_rules` / :func:`decode_rules`
are the reference's production defaults, copied verbatim.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.sharding.spec import MeshAxes, axis_size, spec_placements
from repro_torch.sharding.spec import PartitionSpec as P

_state = threading.local()


def _current():
    """``(mesh, rules)`` of the active context, or None."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, MeshAxes]):
    """Activate logical->mesh axis rules (thread-local)."""
    prev = _current()
    _state.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.ctx = prev


def resolve(logical: Sequence[Optional[str]], rules: Dict[str, MeshAxes]) -> P:
    return P(*[rules.get(ax) if ax is not None else None for ax in logical])


def logical_spec(shape: Sequence[int], logical: Sequence[Optional[str]]) -> P:
    """The spec the active rules give a tensor of ``shape``: each named
    dimension on its mesh axes, or replicated where it is smaller than
    their size or does not divide it (the reference's rule)."""
    mesh, rules = _current()
    if len(shape) != len(logical):
        raise ValueError(f"shard(): rank {len(shape)} vs logical axes {tuple(logical)}")
    spec = []
    for dim, ax in zip(shape, logical):
        mesh_axes = rules.get(ax) if ax is not None else None
        if mesh_axes is None:
            spec.append(None)
            continue
        size = axis_size(mesh, mesh_axes)
        spec.append(mesh_axes if (size <= dim and dim % size == 0) else None)
    return P(*spec)


def logical_placements(shape: Sequence[int], logical: Sequence[Optional[str]]) -> list:
    """``logical_spec`` as ``Shard``/``Replicate`` placements, one per
    dimension of the active mesh."""
    return spec_placements(logical_spec(shape, logical), _current()[0])


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out as the active rules say for its logical axes.

    ``None`` entries mean "no constraint on this dim" (replicated).
    Returns ``x`` itself when no rule context is active; inside one, ``x``
    must be a DTensor on the context's mesh and is redistributed (a
    no-op when it already has those placements)."""
    ctx = _current()
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError("shard() under axis_rules takes a DTensor; distribute the "
                        "parameters and the batch on the rules' mesh first")
    want = logical_placements(x.shape, logical)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(ctx[0], want)


def unflatten_last(t: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """``t`` ``(..., n * width)`` viewed as ``(..., n, width)`` (heads
    out of a projection); see :func:`unflatten_dim`."""
    return unflatten_dim(t, t.ndim - 1, (n, width))


def unflatten_dim(t: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """``t`` with dimension ``dim`` viewed as ``sizes``.  Over a mesh, a
    dimension split over more ranks than ``sizes[0]`` divides is gathered
    first (GSPMD reshards such a reshape itself; DTensor refuses it)."""
    if isinstance(t, DTensor):
        sizes_m = t.device_mesh.shape
        on_dim = [i for i, pl in enumerate(t.placements)
                  if isinstance(pl, Shard) and pl.dim == dim]
        split = 1
        for i in on_dim:
            split *= sizes_m[i]
        if sizes[0] % split:
            t = t.redistribute(t.device_mesh, [Replicate() if i in on_dim else pl
                                               for i, pl in enumerate(t.placements)])
    return t.unflatten(dim, tuple(sizes))


def rule_divides(dim: int, logical: str) -> bool:
    """Does the active rule for ``logical`` shard a dim of this size?

    Lets model code choose between sharding strategies (e.g.
    expert-parallel vs TP-inside-expert in the MoE layer)."""
    ctx = _current()
    if ctx is None:
        return False
    mesh, rules = ctx
    mesh_axes = rules.get(logical)
    if mesh_axes is None:
        return False
    size = axis_size(mesh, mesh_axes)
    return size > 1 and size <= dim and dim % size == 0


def on_mesh(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a tensor the model made: positions, a mask, a RoPE table)
    replicated on ``like``'s mesh when ``like`` is a DTensor; ``t`` itself
    otherwise."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def nonzero(t: torch.Tensor) -> tuple:
    """``t.nonzero(as_tuple=True)``.  DTensor has no rule for it (its
    result's length depends on the data), so a DTensor's is computed whole
    on every rank and replicated."""
    if not isinstance(t, DTensor):
        return t.nonzero(as_tuple=True)
    mesh = t.device_mesh
    whole = t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    return tuple(on_mesh(i, t) for i in whole.nonzero(as_tuple=True))


def write_at(dst: torch.Tensor, index: Sequence[torch.Tensor], values: torch.Tensor) -> None:
    """``dst[index] = values`` in place, cast to ``dst``'s dtype: ``index``
    one 1-D integer tensor for each of ``dst``'s leading dimensions,
    ``values`` ``(n, *dst.shape[len(index):])`` (a cache's K/V writes).

    DTensor takes no in-place scatter into a split tensor, so over a mesh
    each rank writes the entries that fall in its own shard of ``dst``
    (the indices and values whole on every rank; a split trailing
    dimension takes the rank's slice of the values)."""
    if not isinstance(dst, DTensor):
        dst[tuple(index)] = values.to(dst.dtype)
        return
    mesh = dst.device_mesh
    whole = [Replicate()] * mesh.ndim

    def local(t):
        return t.redistribute(mesh, whole).to_local() if isinstance(t, DTensor) else t

    idx, vals = [local(i) for i in index], local(values)
    coord = mesh.get_coordinate()
    lo, size = [0] * dst.ndim, list(dst.shape)
    for m, pl in enumerate(dst.placements):  # a dimension split in mesh order
        if isinstance(pl, Shard):
            chunk = -(-size[pl.dim] // mesh.size(m))
            start = min(coord[m] * chunk, size[pl.dim])
            lo[pl.dim] += start
            size[pl.dim] = min(chunk, size[pl.dim] - start)
    keep = None
    for d, i in enumerate(idx):
        if size[d] != dst.shape[d]:
            ok = (i >= lo[d]) & (i < lo[d] + size[d])
            keep = ok if keep is None else keep & ok
            idx[d] = i - lo[d]
    for d in range(len(idx), dst.ndim):
        if size[d] != dst.shape[d]:
            vals = vals.narrow(d - len(idx) + 1, lo[d], size[d])
    if keep is not None:
        rows = keep.nonzero(as_tuple=True)[0]
        idx, vals = [i[rows] for i in idx], vals[rows]
    dst.to_local()[tuple(idx)] = vals.to(dst.dtype)


def local_call(fn: Callable, args: Sequence[torch.Tensor], in_placements: Sequence,
               out_placements, grad_placements: Optional[Sequence] = None):
    """``fn(*local shards)`` on each rank through ``local_map``: the DTensor
    ``args`` are first redistributed to ``in_placements`` (one list per
    argument; None passes a non-tensor through), the result wrapped back
    with ``out_placements`` (a list, or a tuple of lists for several
    outputs).  ``grad_placements`` says how each argument's gradient lies
    (default: as the argument), e.g. ``Partial`` for a replicated weight
    whose gradient each rank sums over its own rows.  ``fn`` runs with no
    rules active: it sees plain local tensors."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    moved = []
    for a, pl in zip(args, in_placements):
        if isinstance(a, DTensor) and tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        moved.append(a)

    def local(*xs):
        prev, _state.ctx = _current(), None
        try:
            return fn(*xs)
        finally:
            _state.ctx = prev

    return local_map(local, out_placements=out_placements, in_placements=tuple(in_placements),
                     in_grad_placements=None if grad_placements is None else tuple(grad_placements),
                     device_mesh=mesh)(*moved)


def kernel_placements(x: DTensor, logical: Optional[Sequence[Optional[str]]],
                      whole: Sequence[int]) -> list:
    """How a kernel takes ``x``: the placements the active rules give its
    logical axes (``x``'s own outside a context, or with no ``logical``),
    with the dimensions the kernel needs whole (``whole``: the ones it
    reduces or scans over) gathered, and no partial sums."""
    ruled = logical is not None and _current() is not None
    pls = logical_placements(x.shape, logical) if ruled else x.placements
    whole = {d % x.ndim for d in whole}
    return [Replicate() if isinstance(pl, Partial) or (isinstance(pl, Shard) and pl.dim in whole)
            else pl for pl in pls]


def remap(pls: Sequence, dims: Dict[int, int]) -> list:
    """Placements of another operand of the same call: ``Shard(d)`` becomes
    ``Shard(dims[d])`` where that operand has the dimension, else
    ``Replicate``."""
    return [Shard(dims[pl.dim]) if isinstance(pl, Shard) and pl.dim in dims else Replicate()
            for pl in pls]


def partial_where_sharded(pls: Sequence) -> list:
    """The placements of a replicated operand's gradient when the operand
    it meets is laid out as ``pls``: ``Partial`` on each mesh dimension
    that shards it (each rank summed over its own rows), ``Replicate``
    elsewhere."""
    return [Partial() if isinstance(pl, Shard) else Replicate() for pl in pls]


# ----------------------------------------------------------------- rule sets
# Production defaults for the (pod, data, model) / (data, model) meshes.
def train_rules(multi_pod: bool) -> Dict[str, MeshAxes]:
    dp: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "cache_batch": dp,
        "act_batch": dp,  # batch sharding of FFN-local activations
        "act_embed": None,  # hidden-dim sharding of FFN inputs (decode)
        "act_heads": None,  # attention-out contraction sharding (decode)
        "seq": None,
        # Megatron-style sequence parallelism: set to 'model' to carry the
        # residual stream seq-sharded between blocks (TP boundary psums
        # become reduce-scatter + all-gather pairs, 2x fewer bytes)
        "residual_seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        # dispatch buffers (E, C, D): capacity dim over the dp axes so the
        # buffer is data-sharded like the tokens it holds
        "expert_cap": dp,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "kv_seq": None,
    }


def decode_rules(multi_pod: bool, *, seq_sharded_kv: bool = False) -> Dict[str, MeshAxes]:
    r = train_rules(multi_pod)
    if seq_sharded_kv:
        # context parallelism: KV cache sequence dim over the dp axes
        # (long_500k: batch=1, so dp axes are free); heads stay on "model".
        r["kv_seq"] = ("pod", "data") if multi_pod else ("data",)
    return r
