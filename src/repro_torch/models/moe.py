"""Mixture-of-Experts feed-forward (mixtral-style top-k routing, deepseek
shared experts): the reference package's ``models/moe.py`` in torch.

Strategies, selected per call by ``apply_moe``:

- ``dense``: every expert on every token, outputs gated; exact, the
  oracle;
- ``capacity`` (the ``ModelRuntime`` default): a static per-expert
  capacity ``ceil(t·k/e · capacity_factor)``, gather-only dispatch
  (``apply_moe_gather``);
- ``shardmap``: under ``sharding.axis_rules`` on a mesh whose model axis
  the experts divide, the expert-parallel layer of
  ``models.moe_shardmap`` (each rank dispatches its own slice of the
  tokens, an all-to-all over the model axis); elsewhere (no rules, or
  experts that do not divide) the gather path, as in the reference;
- ``capacity_scatter``: the same capacity through scatters
  (``apply_moe_capacity``, the reference's baseline).

Over a mesh (DTensor ``x``) a strategy other than an applicable
``shardmap`` runs whole on every rank (``_whole_on_mesh``): its routing
ops (sort, searchsorted, scatters) have no DTensor sharding rule, and
the drops depend on every token of the batch, so each rank gathers the
tokens and the expert weights and computes the layer as on one device.

Both capacity paths rank the flat ``(token, slot)`` entries by a stable
sort of their expert ids and drop the entries past an expert's capacity
(GShard semantics), so which tokens drop depends on the batch: at decode
``t`` is the number of rows, parked rows included.

Router: float32 logits (the router is kept float32 in every model
dtype), softmax, the top k, gates renormalised over the chosen experts.
Among equal probabilities the lower expert index comes first, as with
``lax.top_k`` (``torch.topk`` breaks ties otherwise).  The gates and the
combine stay float32 and cast back to ``x``'s dtype; the expert products
run in the model dtype as ``torch.matmul`` batched over the experts (the
reference computes them outside any Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import GATED, apply_mlp
from repro_torch.sharding.logical import local_call, rule_divides, shard
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

Params = Dict[str, torch.Tensor]
STRATEGIES = ("dense", "capacity", "capacity_scatter", "shardmap")
FP32_PARAMS = ("router",)  # float32 in every model dtype, as in the reference


def moe_param_tree(cfg: ArchConfig, normal: Callable, mlp: Callable,
                   depth_scale: float) -> Params:
    """One MoE layer's leaves: ``router`` ``(d, E)`` float32, ``wi``/``wg``
    ``(E, d, f)``, ``wo`` ``(E, f, d)`` scaled by ``depth_scale``, and a
    ``shared`` MLP of width ``f · n_shared_experts`` when there is one.
    ``normal(shape, std, dtype=None)`` draws a leaf (the model dtype unless
    named); ``mlp(d_in, f)`` builds an MLP dict."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p: Params = {
        "router": normal((d, e), 1.0 / math.sqrt(d), dtype=torch.float32),
        "wi": normal((e, d, f), 1.0 / math.sqrt(d)),
        "wo": normal((e, f, d), depth_scale / math.sqrt(f)),
    }
    if cfg.activation in GATED:
        p["wg"] = normal((e, d, f), 1.0 / math.sqrt(d))
    if cfg.n_shared_experts:
        p["shared"] = mlp(d, f * cfg.n_shared_experts)
    return p


def _expert_ffn(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x ``(E, C, d)`` (or ``(1, C, d)``, broadcast over the experts) ->
    ``(E, C, d)``, every expert's MLP on its own rows.  Over a mesh the
    experts split the model axis where they divide it (expert
    parallelism), else the hidden width does (TP inside each expert);
    at decode (``act_embed`` active) the model width takes the FSDP axis
    and the capacity releases it, as in the reference."""
    ep = rule_divides(p["wi"].shape[0], "experts")
    dec = rule_divides(x.shape[-1], "act_embed")
    cap_ax = None if dec else "expert_cap"
    h = shard(torch.matmul(x, p["wi"]), "experts", cap_ax, None if ep else "ff")
    if activation == "silu":
        h = F.silu(h) * torch.matmul(x, p["wg"])
    elif activation == "gelu_gated":
        h = F.gelu(h, approximate="tanh") * torch.matmul(x, p["wg"])
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif activation == "relu2":
        h = F.relu(h).square()
    else:
        raise ValueError(activation)
    return shard(torch.matmul(h, p["wo"]), "experts", cap_ax, "act_embed" if dec else None)


def route(p: Params, x: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat tokens ``(T, d)`` -> gates ``(T, k)`` float32 and expert ids
    ``(T, k)`` int64, the experts in descending probability, the lower
    index first among equal ones."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
    return gates / gates.sum(dim=-1, keepdim=True), ids


def capacity(t: int, cfg: ArchConfig) -> int:
    """Slots an expert keeps for ``t`` tokens (the reference's rounding)."""
    return max(int((t * cfg.top_k / cfg.n_experts) * cfg.capacity_factor + 0.999), 1)


def _rank(ids: torch.Tensor):
    """The flat ``(token, slot)`` entries sorted stably by expert id:
    ``(order, sorted_ids, sorted_tok, pos_in_expert)``, ``pos_in_expert``
    each sorted entry's place within its expert's run."""
    t, k = ids.shape
    flat_ids = ids.reshape(t * k)
    flat_tok = torch.arange(t, device=ids.device).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    pos_in_expert = torch.arange(t * k, device=ids.device) - first
    return order, sorted_ids, flat_tok[order], pos_in_expert


def _with_shared(p: Params, x: torch.Tensor, y: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg.activation)
    return y


def apply_moe_dense(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The oracle: every expert on every token, ``(B, S, d)`` in and out."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, ids = route(p, xt, cfg.top_k)
    gmat = torch.zeros((b * s, cfg.n_experts), dtype=torch.float32, device=x.device)
    gmat = gmat.scatter_add(1, ids, gates)  # (T, E)
    ye = _expert_ffn(p, xt[None], cfg.activation)  # (E, T, d)
    y = torch.einsum("etd,te->td", ye.float(), gmat).to(x.dtype).reshape(b, s, d)
    return _with_shared(p, x, y, cfg)


def apply_moe_gather(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Static capacity, gather-only dispatch: expert slot ``(e, c)`` takes
    sorted entry ``starts[e] + c`` when that entry is still expert ``e``'s;
    each token gathers its ``k`` outputs back, the dropped ones weighted 0."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    cap = capacity(t, cfg)
    xt = x.reshape(t, d)
    gates, ids = route(p, xt, k)
    order, sorted_ids, sorted_tok, pos_in_expert = _rank(ids)

    experts = torch.arange(e, device=x.device)
    starts = torch.searchsorted(sorted_ids, experts, side="left")
    ends = torch.searchsorted(sorted_ids, experts, side="right")
    slot_p = starts[:, None] + torch.arange(cap, device=x.device)[None, :]  # (E, C)
    slot_valid = slot_p < ends[:, None]
    slot_tok = sorted_tok[slot_p.clamp(0, t * k - 1)]
    buf = torch.where(slot_valid[..., None], xt[slot_tok], torch.zeros((), dtype=x.dtype,
                                                                      device=x.device))
    dec = rule_divides(d, "act_embed")
    buf = shard(buf, "experts", None if dec else "expert_cap", "act_embed" if dec else None)
    ye = _expert_ffn(p, buf, cfg.activation)  # (E, C, d)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=x.device)
    entry_pos = pos_in_expert[inv].reshape(t, k)
    kept = entry_pos < cap
    y_gathered = ye[ids, entry_pos.clamp(max=cap - 1)]  # (T, k, d)
    w = torch.where(kept, gates, torch.zeros((), device=x.device))
    y = torch.einsum("tkd,tk->td", y_gathered.float(), w).to(x.dtype).reshape(b, s, d)
    return _with_shared(p, x, shard(y, "batch", "seq", "embed"), cfg)


def apply_moe_capacity(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Static capacity through scatters: entries scatter into an ``(E, C,
    d)`` buffer, the dropped ones as zeros into slot ``(E-1, C-1)``, in
    sorted order with the last write to a slot winning (the reference's
    scatter on its CPU backend: a kept entry in that slot reads zeros when
    expert ``E-1`` overflows); outputs scatter-add back weighted by
    their gates."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    cap = capacity(t, cfg)
    xt = x.reshape(t, d)
    gates, ids = route(p, xt, k)
    order, sorted_ids, sorted_tok, pos_in_expert = _rank(ids)
    sorted_gates = gates.reshape(t * k)[order]

    keep = pos_in_expert < cap
    safe_e = torch.where(keep, sorted_ids, e - 1)
    safe_c = torch.where(keep, pos_in_expert, cap - 1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    vals = torch.where(keep[:, None], xt[sorted_tok], zero)
    slot = safe_e * cap + safe_c
    last = torch.full((e * cap,), -1, dtype=torch.long, device=x.device).scatter_reduce(
        0, slot, torch.arange(t * k, device=x.device), "amax")
    buf = torch.where((last >= 0)[:, None], vals[last.clamp(min=0)], zero).reshape(e, cap, d)
    buf = shard(buf, "experts", "expert_cap", "embed")
    ye = _expert_ffn(p, buf, cfg.activation)  # (E, C, d)

    y_entries = ye[safe_e, safe_c]  # (T*k, d)
    weights = torch.where(keep, sorted_gates, torch.zeros((), device=x.device))
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add(
        0, sorted_tok, y_entries.float() * weights[:, None])
    return _with_shared(p, x, shard(y.to(x.dtype).reshape(b, s, d), "batch", "seq", "embed"), cfg)


# without a mesh, shardmap is the gather path (as in the reference)
_STRATEGIES = {"dense": apply_moe_dense, "capacity": apply_moe_gather, "shardmap": apply_moe_gather,
               "capacity_scatter": apply_moe_capacity}


def _whole_on_mesh(fn: Callable, p: Params, x: DTensor, cfg: ArchConfig) -> DTensor:
    """``fn(p, x, cfg)`` on every rank over the whole batch and every
    weight (each replicated), the output laid out as the rules say."""
    paths = [path for path, _ in tree_leaves_with_path(p)]
    leaves = dict(tree_leaves_with_path(p))
    whole = [Replicate()] * x.device_mesh.ndim

    def run(xl, *ws):
        local = dict(zip(paths, ws))
        return fn(tree_map_with_path(lambda path, _: local[path], p), xl, cfg)

    y = local_call(run, [x, *(leaves[k] for k in paths)], [whole] * (len(paths) + 1), whole)
    return shard(y, "batch", "seq", "embed")


def apply_moe(p: Params, x: torch.Tensor, cfg: ArchConfig,
              strategy: str = "capacity") -> torch.Tensor:
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown moe strategy {strategy!r}")
    if isinstance(x, DTensor):
        from repro_torch.models.moe_shardmap import apply_moe_shardmap, shardmap_applicable

        if strategy == "shardmap" and shardmap_applicable(cfg, x.shape):
            return apply_moe_shardmap(p, x, cfg)
        return _whole_on_mesh(_STRATEGIES[strategy], p, x, cfg)
    return _STRATEGIES[strategy](p, x, cfg)
