"""Expert-parallel MoE over the mesh (counterpart of the reference
package's ``models/moe_shardmap.py``).

The reference takes manual control of the MoE layer with ``shard_map``;
the port does so with ``local_map`` over the rules' ``DeviceMesh``, each
rank running these steps on its local shards:

    per (data, model) rank:
      1. router: all-gather the fsdp-sliced router over the dp axes, then
         local logits (never a partial contraction summed over 'data':
         tokens differ across data ranks, so partial logits of different
         tokens must not be added)
      2. slice the local tokens by model rank (each routes T/ntp tokens)
      3. local gather-based dispatch -> (E, C, D)
      4. all_to_all over 'model'     -> (E_loc, C*ntp, D)   [true EP]
      5. all-gather expert weights over the dp axes (FSDP, layer-at-a-time)
      6. local expert FFN
      7. all_to_all back, local combine
    then the block's token slices are gathered over 'model' (the
    DTensor's redistribution from a model-sharded to a replicated layout).

The collectives inside are the autograd functional collectives
(``torch.distributed._functional_collectives``), which carry gradients
on any backend: an all-gather's backward is a reduce-scatter (the
ZeRO-sharded expert and router gradients), an all-to-all's the reverse
all-to-all.  The router and the tokens enter replicated over 'model' but
each model rank differentiates only its slice of tokens, so their
gradients are declared partial over 'model' and summed there.

Falls back to the gather path (``moe.apply_moe_gather``) when experts do
not divide the model axis (mixtral: 8 on 16) or no rules are active.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import Partial

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import dp_axes, mesh_shape
from repro_torch.models.layers import GATED, apply_mlp
from repro_torch.models.moe import _expert_ffn, _rank, capacity, route
from repro_torch.sharding import logical as L
from repro_torch.sharding.spec import PartitionSpec as P
from repro_torch.sharding.spec import spec_placements

Params = Dict[str, torch.Tensor]


def shardmap_applicable(cfg: ArchConfig, x_shape) -> bool:
    ctx = L._current()
    if ctx is None:
        return False
    shape = mesh_shape(ctx[0])
    if "model" not in shape:
        return False
    ntp = shape["model"]
    if cfg.n_experts % ntp:
        return False
    ndp = 1
    for a in dp_axes(shape):
        ndp *= shape[a]
    b, s, _ = x_shape
    if b % ndp:
        return False
    t_block = (b // ndp) * s
    return t_block % ntp == 0


def _gather(t: torch.Tensor, groups, dim: int) -> torch.Tensor:
    """All-gather ``t`` along ``dim`` over each group in turn (the innermost
    mesh axis first), differentiably: the backward reduce-scatters."""
    for g in groups:
        t = fc.wait_tensor(fc.all_gather_tensor_autograd(t.contiguous(), dim, g))
    return t


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Exchange equal chunks of ``t`` along dim 0 with every rank of
    ``group``: chunk ``i`` goes to rank ``i``, the chunk received from
    rank ``i`` lands at position ``i``, differentiably."""
    return fc.wait_tensor(fc.all_to_all_single_autograd(t.contiguous(), None, None, group))


def _local(router_b, wi_b, wg_b, wo_b, xb, *, cfg: ArchConfig, ntp: int, tpi: int,
           dp_groups, tp_group, t_slice: int, cap: int) -> torch.Tensor:
    """One rank's steps 1-7: ``xb`` (b_loc, s, d) -> this model rank's
    slice of the block's outputs (t_slice, d)."""
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // ntp
    d = xb.shape[-1]
    xt = xb.reshape(-1, d)

    # 1. routing over the whole router (all-gathered over the dp axes)
    router = _gather(router_b, dp_groups, 0)
    gates_all, ids_all = route({"router": router}, xt, k)

    # 2. this model rank routes its slice of the local tokens
    sl = slice(tpi * t_slice, (tpi + 1) * t_slice)
    xs, gates, ids = xt[sl], gates_all[sl], ids_all[sl]

    # 3. local gather-based dispatch (moe.apply_moe_gather's scheme)
    order, sorted_ids, sorted_tok, pos_in_expert = _rank(ids)
    experts = torch.arange(e, device=xb.device)
    starts = torch.searchsorted(sorted_ids, experts, side="left")
    ends = torch.searchsorted(sorted_ids, experts, side="right")
    slot_p = starts[:, None] + torch.arange(cap, device=xb.device)[None, :]  # (E, C)
    slot_valid = slot_p < ends[:, None]
    slot_tok = sorted_tok[slot_p.clamp(0, t_slice * k - 1)]
    buf = torch.where(slot_valid[..., None], xs[slot_tok],
                      torch.zeros((), dtype=xb.dtype, device=xb.device))

    # 4. expert-parallel all_to_all: (E, C, D) -> (E_loc, C*ntp, D), the
    # chunks received concatenated along C in source-rank order
    buf = _all_to_all(buf, tp_group).reshape(ntp, e_loc, cap, d)
    buf = buf.transpose(0, 1).reshape(e_loc, ntp * cap, d)

    # 5. FSDP weight gather (layer-at-a-time; backward = reduce-scatter)
    w = {"wi": _gather(wi_b, dp_groups, 1), "wo": _gather(wo_b, dp_groups, 1)}
    if wg_b is not None:
        w["wg"] = _gather(wg_b, dp_groups, 1)

    # 6. local expert FFN on (E_loc, C*ntp, D)
    ye = _expert_ffn(w, buf, cfg.activation)

    # 7. all_to_all back: (E_loc, C*ntp, D) -> (E, C, D), expert ids
    # group-major again on the owning rank; combine this slice's tokens
    ye = ye.reshape(e_loc, ntp, cap, d).transpose(0, 1)
    ye = _all_to_all(ye, tp_group).reshape(e, cap, d)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t_slice * k, device=xb.device)
    entry_pos = pos_in_expert[inv].reshape(t_slice, k)
    kept = entry_pos < cap
    y_gathered = ye[ids, entry_pos.clamp(max=cap - 1)]  # (t_slice, k, d)
    wts = torch.where(kept, gates, torch.zeros((), device=xb.device))
    return torch.einsum("tkd,tk->td", y_gathered.float(), wts).to(xb.dtype)


def apply_moe_shardmap(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The MoE layer of DTensor ``x`` (B, S, D) over the active rules' mesh
    with the expert weights laid out as ``param_specs`` lays them under
    EP: ``router`` P(dp, None), ``wi``/``wg``/``wo`` P("model", dp,
    None)."""
    mesh, _ = L._current()
    shape = mesh_shape(mesh)
    names = list(shape)
    tp = "model"
    ntp = shape[tp]
    dp = dp_axes(shape)
    ndp = 1
    for a in dp:
        ndp *= shape[a]
    b, s, d = x.shape
    gated = cfg.activation in GATED
    t_block = (b // ndp) * s
    t_slice = t_block // ntp
    cap = capacity(t_slice, cfg)

    dp_spec = (dp if len(dp) > 1 else dp[0]) if dp else None
    router_pl = spec_placements(P(dp_spec, None), mesh)
    w_pl = spec_placements(P(tp, dp_spec, None), mesh)
    x_pl = spec_placements(P(dp_spec, None, None), mesh)
    # the router and the tokens: each model rank differentiates only its
    # own slice of the tokens, so their gradients are partial over 'model'
    x_grad = [Partial() if n == tp and ntp > 1 else pl for n, pl in zip(names, x_pl)]
    router_grad = [Partial() if n == tp and ntp > 1 else pl for n, pl in zip(names, router_pl)]
    # the outputs (B*S, D): the dp axes, then 'model', split the rows
    out_pl = spec_placements(P(dp + (tp,), None), mesh)

    fn = functools.partial(
        _local, cfg=cfg, ntp=ntp, tpi=mesh.get_local_rank(tp),
        dp_groups=[mesh.get_group(a) for a in reversed(dp)], tp_group=mesh.get_group(tp),
        t_slice=t_slice, cap=cap)
    args = [p["router"], p["wi"], p["wg"] if gated else None, p["wo"], x]
    pls = [router_pl, w_pl, w_pl if gated else None, w_pl, x_pl]
    grads = [router_grad, w_pl, w_pl if gated else None, w_pl, x_grad]
    y = L.local_call(fn, args, pls, out_pl, grad_placements=grads)
    # reassemble the block's tokens across model ranks
    y = y.redistribute(mesh, spec_placements(P(dp_spec, None), mesh))
    y = L.shard(y.reshape(b, s, d), "batch", "seq", "embed")
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg.activation)
    return y
