"""Model primitives: norms, RoPE, dense/gated MLPs, attention.

Counterpart of the reference package's ``models/layers.py`` in plain
functions on tensors; parameters are plain dicts.  Layouts are the
reference's: activations ``(B, S, d)``, heads ``(B, S, H, hd)``, weights
``(d_in, d_out)``.  RMSNorm goes through ``kernels.ops.rmsnorm`` (the
Hopper kernel on a CUDA tensor, its plain version on the CPU); the math
is the reference's ``apply_norm``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.sharding.logical import (
    on_mesh,
    rule_divides,
    shard,
    unflatten_dim,
    unflatten_last,
)

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30
GATED = {"silu", "gelu_gated"}


# ------------------------------------------------------------------- norms
def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return ops.rmsnorm(x, p["w"], eps=eps)
    if kind != "layernorm":
        raise ValueError(f"unknown norm {kind!r}")
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["w"].float() + p["b"].float()).to(x.dtype)


def rmsnorm_gated(p: Params, x: torch.Tensor, gate: torch.Tensor, eps: float) -> torch.Tensor:
    """Mamba2's gated RMSNorm, ``norm(x * silu(gate)) * w``, rounded where
    the reference rounds: ``x * silu(gate)`` is taken in x's dtype and only
    then widened to fp32.  Plain torch: the reference computes it in jnp,
    not through its RMSNorm kernel."""
    xf = (x * F.silu(gate.float()).to(x.dtype)).float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["w"].float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split (not interleaved) rotary embedding with fp32 angles.
    x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = on_mesh(rope_frequencies(hd, theta, x.device), x)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ------------------------------------------------------------------- MLP
def apply_mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    x = shard(x, "act_batch", "seq", "act_embed")
    h = shard(x @ p["wi"], "batch", "seq", "ff")
    if activation == "silu":
        h = F.silu(h) * (x @ p["wg"])
    elif activation == "gelu_gated":
        h = F.gelu(h, approximate="tanh") * (x @ p["wg"])
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif activation == "relu2":
        h = F.relu(h).square()
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return shard(h @ p["wo"], "batch", "residual_seq", "embed")


# ------------------------------------------------------------------- attention
def qkv_project(
    p: Params, x: torch.Tensor, n_heads: int, n_kv_heads: int, head_dim: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    x = shard(x, "act_batch", "seq", "act_embed")
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        unflatten_last(q, n_heads, head_dim),
        unflatten_last(k, n_kv_heads, head_dim),
        unflatten_last(v, n_kv_heads, head_dim),
    )


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by repeating groups (GQA).  Over a
    mesh whose rules split the query heads but not the KV heads, the KV
    heads are repeated whole and the result laid out as the rules say:
    the repeat's backward views its gradient as ``(Hkv, group)``, which
    DTensor refuses on a heads dimension split more ways than ``Hkv``
    (GSPMD reshards it itself)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    g = n_heads // n_kv
    if isinstance(k, DTensor) and rule_divides(n_heads, "heads") and not rule_divides(
            n_kv, "heads"):
        whole = [Replicate() if isinstance(pl, Shard) and pl.dim == 2 else pl
                 for pl in k.placements]
        out = torch.repeat_interleave(k.redistribute(k.device_mesh, whole), g, dim=2)
        return shard(out, "batch", "seq", "heads", None)
    return torch.repeat_interleave(k, g, dim=2)


def gqa_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd), not repeated
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,  # (B, Sq)
    kv_positions: torch.Tensor,  # (B, Skv)
    sliding_window: int = 0,  # > 0: keys within the window of the query only
    kv_mask: Optional[torch.Tensor] = None,  # (B, Skv) valid cache slots
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Causal grouped-query attention over a contiguous cache without
    repeating KV heads (the reference's ``gqa_attention``: fp32 logits,
    optional tanh softcap, ``-1e30`` mask, probabilities in q's dtype).
    With ``sliding_window`` a key at ``kp`` is seen from ``qp`` only where
    ``qp - window < kp <= qp``, the reference's mask."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = unflatten_dim(q, 2, (hkv, g))
    logits = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float()) * (1.0 / math.sqrt(hd))
    logits = shard(logits, "cache_batch", "kv_heads", None, None, "kv_seq")
    if logit_softcap > 0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    qp = q_positions[:, None, None, :, None]
    kp = kv_positions[:, None, None, None, :]
    mask = kp <= qp
    if sliding_window > 0:
        mask = mask & (kp > qp - sliding_window)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs, v)
    return shard(out.reshape(b, sq, h, hd), "cache_batch", "seq", "heads", "head_dim")


def attention_scores(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, H, hd), KV heads repeated to H
    v: torch.Tensor,
    *,
    causal: bool,
    q_positions: Optional[torch.Tensor] = None,  # (B, Sq); default arange
    kv_positions: Optional[torch.Tensor] = None,  # (B, Skv); default arange
    sliding_window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Skv) valid cache slots
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Direct attention, the reference's ``attention_scores``: fp32 logits
    (the inputs upcast, so bf16 products are exact), optional tanh
    softcap, causal / sliding-window / KV masks at ``-1e30``, and the
    probabilities cast to q's dtype before the PV product."""
    sq, hd = q.shape[1], q.shape[3]
    skv = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    logits = shard(logits, "batch", "heads", None, "kv_seq")
    if logit_softcap > 0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if q_positions is None:
        q_positions = on_mesh(torch.arange(sq, device=q.device)[None, :], q)
    if kv_positions is None:
        kv_positions = on_mesh(torch.arange(skv, device=q.device)[None, :], q)
    qp = q_positions[:, None, :, None]
    kp = kv_positions[:, None, None, :]
    mask = on_mesh(torch.ones((), dtype=torch.bool, device=q.device), q)
    if causal:
        mask = kp <= qp
    if sliding_window > 0:
        mask = mask & (kp > qp - sliding_window)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return shard(torch.einsum("bhqk,bkhd->bqhd", probs, v), "batch", "seq", "heads", "head_dim")
