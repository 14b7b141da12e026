"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the
reference package's ``models/mla.py`` in torch.

K/V are compressed to a per-token latent ``c_kv`` of rank
``kv_lora_rank`` plus one shared RoPE key of ``rope_head_dim``; queries
take their own low-rank path.  The decode cache holds only those
``kv_lora_rank + rope_head_dim`` values a token a layer, and attention
against it runs in latent space with ``k_up`` absorbed into the query
and ``v_up`` applied after the value product, so the cache is never
expanded to per-head keys:

    score(t) = q_nope . (c_kv[t] K_up) + q_rope . k_rope[t]
             = (q_nope K_up^T) . c_kv[t] + q_rope . k_rope[t]
    out      = softmax . (c_kv V_up) = (softmax . c_kv) V_up

Every score is scaled by ``1 / sqrt(nope_head_dim + rope_head_dim)``.
The full-sequence path (``apply_mla``) and the dense-cache paths
(``apply_mla_extend``, ``apply_mla_decode``) are plain einsums with the
probabilities rounded to the activations' dtype before the value product,
as in the reference.  The paged path (``apply_mla_paged``) serves each
slot's ``concat(c_kv, k_rope)`` through ``ops.paged_attention`` as its
``Hkv = 1`` case, values read from the first ``kv_lora_rank`` columns of
the same page (``v_width``), the probabilities kept in f32 as the
reference's kernel route keeps them.

Caches are updated in place and returned, so call sites read as the
reference's.  Where the reference masks its writes with ``valid`` (and
drops the out-of-bounds ones), the cache paths take the writes
themselves, computed once a dispatch and shared by every layer: ``(rows,
tokens)`` for the dense cache, ``write_slots``' ``(rows, tokens, pages,
offsets)`` for the paged one, so parked rows and padded tokens write
nothing.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import NEG_INF, apply_norm, apply_rope
from repro_torch.sharding.logical import on_mesh, shard, unflatten_last, write_at

Params = Dict[str, torch.Tensor]


def mla_param_tree(cfg: ArchConfig, dense: Callable, norm: Callable,
                   depth_scale: float) -> Params:
    """One MLA layer's leaves (the reference's ``mla_init``): ``q_down``
    ``(d, q_lora)``, ``q_norm``, ``q_up`` ``(q_lora, H (nope + rope))``,
    ``kv_down`` ``(d, r + rope)``, ``kv_norm`` over ``r``, ``k_up`` ``(r, H
    nope)``, ``v_up`` ``(r, H v)`` and ``wo`` ``(H v, d)`` scaled by
    ``depth_scale``.  ``dense(d_in, d_out, scale=1.0)`` draws a weight,
    ``norm(width)`` builds a norm's dict."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    qk, qr, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "q_down": dense(d, cfg.q_lora_rank),
        "q_norm": norm(cfg.q_lora_rank),
        "q_up": dense(cfg.q_lora_rank, h * (qk + qr)),
        "kv_down": dense(d, r + qr),
        "kv_norm": norm(r),
        "k_up": dense(r, h * qk),
        "v_up": dense(r, h * vd),
        "wo": dense(h * vd, d, depth_scale),
    }


def _scale(cfg: ArchConfig) -> float:
    return 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)


def _project_q(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """``(q_nope (b, s, H, nope), q_rope (b, s, H, rope))``, RoPE applied."""
    b, s, _ = x.shape
    h, qk, qr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    q = apply_norm(p["q_norm"], x @ p["q_down"], cfg.norm, cfg.norm_eps) @ p["q_up"]
    q = unflatten_last(q, h, qk + qr)
    return q[..., :qk], apply_rope(q[..., qk:], positions, cfg.rope_theta)


def _compress_kv(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """``(c_kv (b, s, r), k_rope (b, s, rope))``: what the decode cache
    holds.  The latent is normed as its own contiguous tensor (the RMSNorm
    kernel takes contiguous rows), and the RoPE key is rotated as one head."""
    r = cfg.kv_lora_rank
    kv = x @ p["kv_down"]
    c_kv = apply_norm(p["kv_norm"], kv[..., :r].contiguous(), cfg.norm, cfg.norm_eps)
    k_rope = apply_rope(kv[..., r:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def apply_mla(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence (train / eval / prefill) MLA with causal masking:
    per-head keys and values expanded from the latent."""
    b, s, _ = x.shape
    h, qk, vd = cfg.n_heads, cfg.nope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = on_mesh(torch.arange(s, device=x.device)[None, :], x)
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_kv, k_rope = _compress_kv(p, x, cfg, positions)
    k_nope = shard(unflatten_last(c_kv @ p["k_up"], h, qk), "batch", "seq", "heads", "head_dim")
    v = shard(unflatten_last(c_kv @ p["v_up"], h, vd), "batch", "seq", "heads", "head_dim")
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())) * _scale(cfg)
    logits = shard(logits, "batch", "heads", None, "kv_seq")
    mask = positions[:, None, None, :] <= positions[:, None, :, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * vd)
    return shard(out @ p["wo"], "batch", "seq", "embed")


def mla_decode_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """One layer's dense cache: ``c_kv`` ``(batch, max_len, r)`` and
    ``k_rope`` ``(batch, max_len, rope)``, zeros."""
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dtype, device=device),
    }


def _absorbed_value(p: Params, ctx: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``ctx (b, T, H, r)`` in latent space -> the layer's output ``(b, T,
    d)``: ``v_up`` applied per head, then ``wo``."""
    b, T = ctx.shape[:2]
    h, vd, r = cfg.n_heads, cfg.v_head_dim, cfg.kv_lora_rank
    out = torch.einsum("bqhr,rhd->bqhd", ctx, p["v_up"].reshape(r, h, vd))
    return shard(out.reshape(b, T, h * vd) @ p["wo"], "batch", "seq", "embed")


def _absorbed_query(p: Params, q_nope: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``q_nope (b, T, H, nope)`` -> ``q_lat (b, T, H, r)``: ``k_up``
    absorbed into the query."""
    r, h, qk = cfg.kv_lora_rank, cfg.n_heads, cfg.nope_head_dim
    return torch.einsum("bqhd,rhd->bqhr", q_nope, p["k_up"].reshape(r, h, qk))


def apply_mla_extend(
    p: Params,
    x: torch.Tensor,  # (b, T, d) chunk of new tokens
    cache: Dict[str, torch.Tensor],  # c_kv (b, t, r), k_rope (b, t, rope)
    positions: torch.Tensor,  # (b, T) absolute cache positions of the chunk
    cfg: ArchConfig,
    writes: Tuple[torch.Tensor, torch.Tensor],  # (rows, tokens) of the real tokens
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked-prefill MLA: ``T`` new tokens a row against the dense
    latent cache in one shot, absorbed form.  The ``writes`` tokens write
    their latent and RoPE key at their position, in place, and every query
    attends the slots at or before its position."""
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_new, kr_new = _compress_kv(p, x, cfg, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    t = c_kv.shape[1]
    rows, toks = writes
    # a parked row's stale position may sit past the cache (the reference
    # drops that write; indexing past the end would raise)
    slot = positions[rows, toks] % t
    write_at(c_kv, (rows, slot), c_new[rows, toks])
    write_at(k_rope, (rows, slot), kr_new[rows, toks])
    c_kv = shard(c_kv, "cache_batch", "kv_seq", None)
    k_rope = shard(k_rope, "cache_batch", "kv_seq", None)
    q_lat = _absorbed_query(p, q_nope, cfg)
    logits = (torch.einsum("bqhr,btr->bhqt", q_lat.float(), c_kv.float())
              + torch.einsum("bqhd,btd->bhqt", q_rope.float(), k_rope.float())) * _scale(cfg)
    slots = on_mesh(torch.arange(t, device=x.device), x)
    mask = slots[None, None, None, :] <= positions[:, None, :, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqt,btr->bqhr", probs, c_kv)
    return _absorbed_value(p, ctx, cfg), cache


def apply_mla_decode(
    p: Params,
    x: torch.Tensor,  # (b, 1, d)
    cache: Dict[str, torch.Tensor],
    pos: torch.Tensor,  # () or (b,) current positions
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against the dense latent cache: every row writes
    its token at its position (parked rows included, as in the reference)
    and attends what it has written, the chunk-extend at ``T = 1``."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long().expand(b)
    every = (torch.arange(b, device=x.device), torch.zeros(b, dtype=torch.long, device=x.device))
    return apply_mla_extend(p, x, cache, pos[:, None], cfg, every)


def mla_page_width(cfg: ArchConfig) -> int:
    """Columns a paged-cache slot holds: the latent ``c_kv`` and the
    shared RoPE key."""
    return cfg.kv_lora_rank + cfg.rope_head_dim


def apply_mla_paged(
    p: Params,
    x: torch.Tensor,  # (b, T, d): T = 1 is decode, T > 1 chunk-extend
    kv_pages: torch.Tensor,  # (n_pages, ps, r + rope): this layer's page pool
    page_table: torch.Tensor,  # (b, P) int32; entries >= n_pages = unallocated
    positions: torch.Tensor,  # (b, T) absolute cache positions
    cfg: ArchConfig,
    slots: Tuple[torch.Tensor, ...],  # (rows, tokens, pages, offsets) of the writes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLA decode / chunk-extend against a paged latent cache.  Each slot
    holds ``concat(c_kv, k_rope)``, so the absorbed score is one dot of
    ``q_eff = concat(q_lat, q_rope)`` against it and ``ops.paged_attention``
    serves it with one KV head, the pool passed as both K and V and the
    values read from its first ``kv_lora_rank`` columns."""
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_new, kr_new = _compress_kv(p, x, cfg, positions)
    rows, toks, pages, offs = slots
    write_at(kv_pages, (pages, offs), torch.cat([c_new, kr_new], dim=-1)[rows, toks])
    q_eff = torch.cat([_absorbed_query(p, q_nope, cfg), q_rope], dim=-1)  # (b, T, H, r + rope)
    kv = kv_pages[:, :, None, :]
    ctx = ops.paged_attention(q_eff, kv, kv, page_table, positions[:, 0], scale=_scale(cfg),
                              v_width=cfg.kv_lora_rank)  # (b, T, H, r)
    return _absorbed_value(p, ctx, cfg), kv_pages
