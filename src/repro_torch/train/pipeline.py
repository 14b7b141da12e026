"""GPipe-style pipeline parallelism over a ``"pipe"`` mesh dimension
(counterpart of the reference package's ``train/pipeline.py``).

The layer stack is split into S stages, one a rank of the pipe
dimension; microbatches stream through the classic GPipe schedule (S + M
- 1 slots, bubble fraction (S-1)/(S+M-1)).  Each slot every stage runs
``stage_fn`` on what it holds: stage 0 takes in microbatch t, the others
what the stage before handed them, and the hand-off is one
``dist.batch_isend_irecv`` of the slot's output to the next stage on the
pipe group (the reference's ``ppermute``).  The last stage banks
microbatch t - S + 1; the result is an all-reduce over the pipe group of
each stage's banked outputs masked to the last stage's (the reference's
``psum``), so every stage returns all M outputs.

Forward only, as the reference's test runs it: the hand-offs carry no
gradient.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.tree import tree_map

Pytree = object


def _stage_slice(leaf: torch.Tensor, sid: int) -> torch.Tensor:
    """This stage's parameters: the local shard of a leaf laid out over
    the pipe dimension (``Shard(0)``, one stage a rank), or row ``sid`` of
    a full stack."""
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[sid]


def pipeline_apply(
    mesh,
    stage_params: Pytree,  # leaves stacked over stages: (S, ...)
    x: torch.Tensor,  # (M, mb, ...) microbatched input, the same on every stage
    stage_fn: Callable[[Pytree, torch.Tensor], torch.Tensor],
    *,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run ``x`` through the S stages of the mesh's ``axis``; returns the
    (M, mb, ...) outputs on every stage (a replicated DTensor when ``x``
    is a DTensor)."""
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    like = x
    if isinstance(x, DTensor):
        x = x.full_tensor()
    m = x.shape[0]
    params = tree_map(lambda a: _stage_slice(a, sid), stage_params)
    nxt = dist.get_global_rank(group, sid + 1) if sid < n_stages - 1 else None
    prev = dist.get_global_rank(group, sid - 1) if sid > 0 else None

    state = torch.zeros_like(x[0])  # the activation this stage holds
    outputs = torch.zeros_like(x)
    for t in range(m + n_stages - 1):
        # stage 0 takes in microbatch t (clamped past M: its output is
        # never banked)
        inp = x[min(t, m - 1)] if sid == 0 else state
        out = stage_fn(params, inp)
        # the last stage banks microbatch t - S + 1 once it is real
        if sid == n_stages - 1 and t >= n_stages - 1:
            outputs[t - (n_stages - 1)] = out.to(outputs.dtype)
        # hand off to the next stage
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, out.contiguous(), nxt, group))
        if prev is not None:
            state = torch.empty_like(state)
            ops.append(dist.P2POp(dist.irecv, state, prev, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # every stage returns the last stage's banked outputs
    outputs = outputs * float(sid == n_stages - 1)
    dist.all_reduce(outputs, group=group)
    if isinstance(like, DTensor):
        return DTensor.from_local(outputs, like.device_mesh,
                                  [Replicate()] * like.device_mesh.ndim, run_check=False)
    return outputs


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + n_microbatches - 1)
