"""The dense decoder, the MoE family (mixtral; deepseek with MLA), the
SSM (mamba2) family, the hybrid (zamba2) family, the VLM backbone
(internvl2) and the encoder-decoder (whisper): full-sequence forward,
loss and the serving path on a paged or a dense (per-slot) cache.

Counterpart of the reference package's ``models/transformer.py``:

    model = Model(cfg, ModelRuntime(dtype=torch.bfloat16))
    params = model.init(seed, device="cuda")
    params = model.draw(torch.Generator("cuda").manual_seed(seed))  # drawn on the card
    logits = model.forward(params, tokens)              # (B, S, Vp)
    logits = model.forward(params, tokens, patches=p)   # VLM: (B, n_vision + S, Vp)
    logits = model.forward(params, tokens, frames=f)    # encoder-decoder: (B, S, Vp)
    loss, metrics = model.loss(params, {"tokens": ..., "labels": ...})
    cache = model.init_cache(batch, max_len)            # dense, the default
    cache = model.init_cache(batch, max_len, paged=True, page_size=16, n_pages=N)
    logits, cache = model.decode_step(params, cache, tokens, pos)
    logits, cache = model.prefill_chunk(params, cache, tokens, offsets, lengths)
    logits, cache = model.verify_chunk(params, cache, tokens, offsets, lengths)  # (B, T, Vp)

The full-sequence path chooses its attention by ``ModelRuntime``
(``resolve_attn``): ``direct`` (``layers.attention_scores``),
``chunked`` (online softmax over KV chunks in plain torch) or
``kernel`` (``ops.flash_attention``, the Hopper flash kernel, forward
only); an SSM layer chooses its scan by ``resolve_ssd``: the plain
``ssm.ssd_chunked`` or ``ops.ssd`` (the Hopper SSD chunk kernel, forward
only); a MoE layer's feed-forward follows ``moe_strategy``
(``moe.apply_moe``); an MLA layer (``cfg.use_mla``) runs
``mla.apply_mla``, plain einsums and never the flash kernel, as in the
reference.  A VLM's forward takes the stub frontend's ``patches``
``(B, n_vision_tokens, d)``, cast to the model dtype and put ahead of the
token embeddings, positions running over the whole stream; its loss
drops the patches' logits.  Its serving path ingests tokens alone, one a
dispatch (``supports_fused_prefill``), as the reference's does.  An
encoder-decoder's forward runs the encoder over the stub frontend's
``frames`` ``(B, encoder_seq, d)`` (non-causal, no RoPE) and adds each
decoder layer's cross attention to its output; learned positions
(``max_position_embeddings``) replace RoPE.  On the card all three
attentions take the flash kernel; decode reads each layer's cross cache
through the paged kernel (``cross_page_view``).  Its serving path takes
the dense cache, a token a dispatch.  Layers
run as a Python loop over the per-layer dicts (the reference scans
stacked layers).

Remat (``ModelRuntime.remat``, ``remat_segment``) follows the reference's
``_run_layers``/``_run_hybrid``: the full-sequence forward checkpoints
each layer (``torch.utils.checkpoint``, non-reentrant), or with
``remat_segment`` k > 1 each run of k layers, in each group (a MoE's
``first_k_dense`` dense layers, then the rest) whose length k divides;
a group it does not divide is checkpointed a layer at a time.  The
hybrid checkpoints each SSM layer alone, never its shared block, and
ignores the segment.  The encoder-decoder takes no remat, in its
encoder or decoder, as in the reference; nor do the serving paths.
The checkpoint is non-reentrant so its forward runs with the gradient
enabled: the recompute then resolves the same attention and SSD route
(both read ``requires_grad``) as the forward it replays.

Parameters are a plain dict: ``embed`` ``(Vp, d)``, ``layers`` (a list,
one dict per layer: ``ln1``, ``attn`` {wq, wk, wv, wo} (MLA's leaves, see
``mla.mla_param_tree``, when ``cfg.use_mla``), ``ln2``, ``mlp``
{wi, wg, wo}, or in a MoE layer ``moe`` {router, wi, wg, wo, shared},
see ``moe.moe_param_tree``, the ``first_k_dense`` dense layers first; or
for an SSM layer ``ln1`` and ``mixer``, see ``ssm.mamba2_param_tree``),
``ln_f`` and ``lm_head`` ``(d, Vp)``.  An encoder-decoder adds
``encoder`` (``layers``, ``ln_f``, its frame positions ``pos``
``(encoder_seq, d)``), ``cross`` (a list, one ``ln`` and ``attn`` a
decoder layer) and the decoder's ``pos`` ``(max_position_embeddings,
d)``; LayerNorm carries a bias ``b``.  A
hybrid model adds ``shared``: one transformer block at width ``2 d``
(``ln1``, ``attn``, ``ln2``, ``mlp``, ``down`` back to ``d``) run before
each full segment of ``shared_attn_every`` SSM layers, its ``wq`` offset
per invocation by a LoRA product (``lora_a`` ``(n_inv, 2d, r)``,
``lora_b`` ``(n_inv, r, 2d)``, stacked over the invocations as in the
reference).

Caches are stacked over the layers and updated in place (the reference
returns a new cache pytree); both calls still return the cache so call
sites read alike.  The paged cache holds ``page_table``, ``k_pages`` and
``v_pages`` (MLA: one latent pool ``kv_pages`` ``(L, n_pages, ps, r +
rope)``); the dense cache ``k``/``v`` ``(L, B, t, Hkv, hd)`` for the
attention families (``t = max_len``, or with a sliding window the rolling
``min(max_len, pad128(window + 1))`` slots written at ``position % t``;
an encoder-decoder adds ``cross_k``/``cross_v`` ``(L, B, encoder_seq,
Hkv, hd)``;
MLA: ``c_kv`` ``(L, B, max_len, r)`` and ``k_rope`` ``(L, B, max_len,
rope)``) and, for an SSM, ``state``: the conv windows ``(L, B,
k-1, c)`` in the model dtype and ``ssm`` ``(L, B, h, p, n)`` in fp32; a
hybrid adds the shared block's ``shared_k``/``shared_v`` ``(n_inv, B,
max_len, Hkv, 2d / H)``.
Every decode dispatch advances every row of a dense cache, parked rows
included (a new admission zeroes its row first, as in the reference).

Writes to the paged cache are masked explicitly.  The reference relies
on JAX dropping out-of-bounds scatters for a parked row (its table entry
is the sentinel ``n_pages``) and for padded prefill tokens (sent to
``n_pages``); indexing a torch tensor out of range raises on the CPU and
kills the CUDA context, so only valid ``(row, token)`` pairs are written,
in the dense cache as in the paged one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.models import mla, moe, ssm
from repro_torch.models.layers import (
    GATED,
    apply_mlp,
    apply_norm,
    apply_rope,
    attention_scores,
    gqa_attention,
    qkv_project,
    repeat_kv,
)
from repro_torch.sharding.logical import nonzero, on_mesh, shard, unflatten_last, write_at

Params = Dict[str, Any]
ATTN_IMPLS = ("auto", "direct", "chunked", "kernel")
CROSS_PAGE_SIZE = 20  # the most keys a page of the cross cache's page view holds


@dataclass(frozen=True)
class ModelRuntime:
    """Execution knobs, orthogonal to the architecture (logits are always
    float32, the reference's default)."""

    dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"  # auto | direct | chunked | kernel
    attn_chunk: int = 1024
    use_ssd_kernel: Optional[bool] = None  # None = resolve_ssd's rule
    moe_strategy: str = "capacity"  # dense | capacity | capacity_scatter | shardmap
    remat: bool = False
    # 0 = checkpoint every layer; k > 1 = checkpoint every k layers of a
    # group whose length k divides (the reference's sqrt-remat)
    remat_segment: int = 0

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in {ATTN_IMPLS}")
        if self.moe_strategy not in moe.STRATEGIES:
            raise ValueError(f"moe_strategy {self.moe_strategy!r} not in {moe.STRATEGIES}")

    def resolve_attn(self, seq_len: int, *, device=None, grad: bool = False,
                     head_dim: int = 0, causal: bool = True) -> str:
        """The full-sequence attention implementation over ``seq_len``
        queries, causal or not.  An explicit
        ``attn_impl`` is obeyed.  ``auto`` keeps the reference's rule
        (``direct`` up to 4096 tokens, else ``chunked``) on the CPU and
        wherever a gradient is taken; on a CUDA device with no gradient it
        takes the flash kernel wherever ``flash.supports`` the call, as
        the reference's ``resolve_paged_attn`` picks its kernel on its own
        accelerator."""
        if self.attn_impl != "auto":
            return self.attn_impl
        on_card = device is not None and torch.device(device).type == "cuda"
        if on_card and not grad and flash.supports(seq_len, head_dim, causal=causal):
            return "kernel"
        return "chunked" if seq_len > 4096 else "direct"

    def resolve_ssd(self, *, device=None, grad: bool = False) -> bool:
        """Whether an SSM layer runs ``ops.ssd`` (the Hopper SSD chunk
        kernel) rather than the plain ``ssd_chunked``.  An explicit
        ``use_ssd_kernel`` is obeyed; ``None`` takes the kernel on a CUDA
        device when no gradient is taken (the kernel has no backward, as
        in the reference), the plain path on the CPU or under a gradient."""
        if self.use_ssd_kernel is not None:
            return self.use_ssd_kernel
        on_card = device is not None and torch.device(device).type == "cuda"
        return on_card and not grad


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (prefer multiples of 128)."""
    best = 1
    for c in range(min(target, s), 0, -1):
        if s % c == 0:
            if c % 128 == 0:
                return c
            if best == 1:
                best = c  # best non-128-aligned fallback so far
    return best


def chunked_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, H, hd), KV heads repeated
    v: torch.Tensor,
    *,
    causal: bool,
    sliding_window: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's pure-jnp
    flash pattern, its ``lax.scan`` loops written out).  Memory is
    O(B·H·chunk²); every chunk pair is computed, masked, as the
    reference does."""
    b, s, h, hd = q.shape
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nq = s // chunk
    scale = 1.0 / math.sqrt(hd)

    def split(x):  # (nq, b, h, c, hd)
        return x.reshape(b, nq, chunk, h, hd).permute(1, 0, 3, 2, 4)

    qs, ks, vs = split(q), split(k), split(v)
    ar = on_mesh(torch.arange(chunk, device=q.device), q)
    outs = []
    for iq in range(nq):
        qi = qs[iq]
        q_pos = iq * chunk + ar
        m = on_mesh(torch.full((b, h, chunk), -math.inf, dtype=torch.float32, device=q.device), q)
        l = on_mesh(torch.zeros((b, h, chunk), dtype=torch.float32, device=q.device), q)
        acc = on_mesh(torch.zeros((b, h, chunk, hd), dtype=torch.float32, device=q.device), q)
        for jk in range(nq):
            k_pos = jk * chunk + ar
            logits = torch.einsum("bhqd,bhkd->bhqk", qi.float(), ks[jk].float()) * scale
            mask = on_mesh(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device), q)
            if causal:
                mask = k_pos[None, :] <= q_pos[:, None]
            if sliding_window > 0:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - sliding_window)
            logits = logits.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(  # f32 accumulation of q-dtype P, V
                "bhqk,bhkd->bhqd", p.to(qi.dtype).float(), vs[jk].float())
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    return torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, hd)


def _full_attention(q, k, v, rt: ModelRuntime, *, causal: bool, q_positions, kv_positions,
                    sliding_window: int = 0, logit_softcap: float = 0.0) -> torch.Tensor:
    """Attention of ``q`` ``(B, Sq, H, hd)`` over ``k``/``v`` ``(B, Skv,
    H, hd)`` (KV heads repeated) by ``rt.resolve_attn``: the flash kernel
    (no logit softcap, as the reference's kernel branch; a non-causal call
    passes blocks equal to its lengths, which ``flash.supports`` counts
    on), ``chunked`` where the lengths are equal, else ``direct``."""
    sq, skv, hd = q.shape[1], k.shape[1], q.shape[3]
    impl = rt.resolve_attn(sq, device=q.device, grad=q.requires_grad, head_dim=hd,
                           causal=causal)
    if impl == "kernel":
        blocks = {} if causal else dict(block_q=sq, block_k=skv)
        return ops.flash_attention(q, k, v, causal=causal, sliding_window=sliding_window,
                                   **blocks)
    if impl == "chunked" and sq == skv:
        return chunked_attention(q, k, v, causal=causal, sliding_window=sliding_window,
                                 chunk=_pick_chunk(sq, rt.attn_chunk))
    return attention_scores(q, k, v, causal=causal, sliding_window=sliding_window,
                            q_positions=q_positions, kv_positions=kv_positions,
                            logit_softcap=logit_softcap)


def _attn_forward(p: Params, x: torch.Tensor, cfg: ArchConfig, rt: ModelRuntime, *,
                  positions: torch.Tensor, causal: bool = True, use_rope: bool = True,
                  n_heads: Optional[int] = None, n_kv: Optional[int] = None,
                  head_dim: Optional[int] = None) -> torch.Tensor:
    """Full-sequence self-attention of one layer (the reference's
    ``_attn_forward``): causal in a decoder, not in an encoder; RoPE
    unless the model learns its positions.  The heads default to the
    config's, the hybrid's shared block passes its own."""
    h, hkv = n_heads or cfg.n_heads, n_kv or cfg.n_kv_heads
    hd = head_dim or cfg.resolved_head_dim
    b, s, _ = x.shape
    q, k, v = qkv_project(p, x, h, hkv, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
    out = _full_attention(q, repeat_kv(k, h), repeat_kv(v, h), rt, causal=causal,
                          q_positions=positions, kv_positions=positions,
                          sliding_window=cfg.sliding_window,
                          logit_softcap=cfg.attn_logit_softcap)
    return shard(out.reshape(b, s, h * hd) @ p["wo"], "batch", "residual_seq", "embed")


def _project(p: Params, x: torch.Tensor, name: str, heads: int, hd: int) -> torch.Tensor:
    """One of ``qkv_project``'s three projections alone (``name`` q, k or
    v), bias included where there is one: ``(B, S, heads, hd)``."""
    y = x @ p[f"w{name}"]
    if f"b{name}" in p:
        y = y + p[f"b{name}"]
    return unflatten_last(y, heads, hd)


def _cross_forward(p: Params, x: torch.Tensor, enc: torch.Tensor, cfg: ArchConfig,
                   rt: ModelRuntime, positions: torch.Tensor) -> torch.Tensor:
    """A decoder layer's cross attention over the encoder's output (the
    reference's, inlined in its ``_run_decoder_with_cross``): queries from
    the normed stream ``x``, keys and values from ``enc``, no mask, no
    RoPE.  The reference attends directly; on the card this takes the
    flash kernel (``_full_attention``)."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    q = _project(p, x, "q", h, hd)
    k, v = (repeat_kv(_project(p, enc, n, hkv, hd), h) for n in "kv")
    enc_pos = on_mesh(torch.arange(enc.shape[1], device=enc.device)[None].expand(b, -1), enc)
    out = _full_attention(q, k, v, rt, causal=False, q_positions=positions,
                          kv_positions=enc_pos)
    return out.reshape(b, s, h * hd) @ p["wo"]


@lru_cache(maxsize=None)
def cross_page_view(batch: int, n_keys: int, device: torch.device) -> Tuple[int, torch.Tensor,
                                                                             torch.Tensor]:
    """How decode reads the cross cache through the paged kernel: a layer's
    ``(B, n_keys, Hkv, hd)`` slice, contiguous, is a pool of ``B * P``
    pages of ``ps`` keys (``ps`` the largest divisor of ``n_keys`` up to
    ``CROSS_PAGE_SIZE``: 20 at whisper's 1,500 frames), row ``b`` owning
    pages ``b P .. b P + P - 1``; every row's query sits at position
    ``n_keys - 1``, so the kernel's ``kv_pos <= q_pos`` admits every key,
    the reference's ``causal=False``.  ``(ps, table (B, P) int32, offsets
    (B,) int32)``, built once a shape and device (no host sync in a
    dispatch)."""
    ps = max(d for d in range(1, min(CROSS_PAGE_SIZE, n_keys) + 1) if n_keys % d == 0)
    n_pages = n_keys // ps
    table = torch.arange(batch * n_pages, dtype=torch.int32, device=device).view(batch, n_pages)
    offsets = torch.full((batch,), n_keys - 1, dtype=torch.int32, device=device)
    return ps, table, offsets


def _cross_decode(p: Params, x: torch.Tensor, cross_k, cross_v, cfg: ArchConfig) -> torch.Tensor:
    """A decode dispatch's cross attention of one layer over its cross cache
    ``(B, encoder_seq, Hkv, hd)`` (the reference's block in its
    ``_decode_attn``: unmasked, no RoPE), through ``ops.paged_attention``
    over the cache's page view (``cross_page_view``): the paged kernel on
    the card, its plain version on the CPU."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, n_keys = cross_k.shape[0], cross_k.shape[1]
    ps, table, offsets = cross_page_view(b, n_keys, cross_k.device)
    pool = (b * n_keys // ps, ps, hkv, hd)
    out = ops.paged_attention(_project(p, x, "q", h, hd), cross_k.view(pool),
                              cross_v.view(pool), table, offsets)
    return out.reshape(b, x.shape[1], h * hd) @ p["wo"]


def _attn_dense_cache(p: Params, x, cache_k, cache_v, positions, writes, cfg: ArchConfig, *,
                      n_heads: Optional[int] = None, n_kv: Optional[int] = None,
                      head_dim: Optional[int] = None, use_rope: bool = True):
    """Decode or chunked prefill against a dense per-slot KV cache ``(B, t,
    Hkv, hd)`` (the reference's ``_attn_decode``/``_attn_extend``): the
    tokens ``writes = (rows, toks)`` write their K/V at ``position % t``, in
    place, and every query attends to the slots at or before its position;
    slot ``s`` holds ``last - ((last - s) mod t)``, the reference's
    reconstruction (the slot itself while the cache does not wrap; negative
    = never written), within ``cfg.sliding_window`` of it when there is
    one.  The heads default to the config's; RoPE unless ``use_rope`` is
    off (learned positions)."""
    h, hkv = n_heads or cfg.n_heads, n_kv or cfg.n_kv_heads
    hd = head_dim or cfg.resolved_head_dim
    b, T, _ = x.shape
    q, k, v = qkv_project(p, x, h, hkv, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    t = cache_k.shape[1]
    rows, toks = writes
    write = positions[rows, toks] % t
    write_at(cache_k, (rows, write), k[rows, toks])
    write_at(cache_v, (rows, write), v[rows, toks])
    cache_k = shard(cache_k, "cache_batch", "kv_seq", "kv_heads", "head_dim")
    cache_v = shard(cache_v, "cache_batch", "kv_seq", "kv_heads", "head_dim")
    last = positions[:, -1:]
    slots = on_mesh(torch.arange(t, device=x.device)[None, :], x)
    kv_pos = last - torch.remainder(last - slots, t)
    out = gqa_attention(q, cache_k, cache_v, q_positions=positions, kv_positions=kv_pos,
                        sliding_window=cfg.sliding_window, kv_mask=kv_pos >= 0,
                        logit_softcap=cfg.attn_logit_softcap)
    out = shard(out.reshape(b, T, h * hd), "act_batch", "seq", "act_heads")
    return shard(out @ p["wo"], "batch", "seq", "embed")


def _mixer_apply(p: Params, x, cfg: ArchConfig, rt: ModelRuntime, positions) -> torch.Tensor:
    xn = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    if "mixer" in p:
        use_kernel = rt.resolve_ssd(device=xn.device, grad=xn.requires_grad)
        return ssm.apply_mamba2(p["mixer"], xn, cfg, use_kernel=use_kernel)
    if cfg.use_mla:
        return mla.apply_mla(p["attn"], xn, cfg, positions=positions)
    # archs with learned absolute positions (whisper) do not use RoPE
    return _attn_forward(p["attn"], xn, cfg, rt, positions=positions,
                         use_rope=not cfg.max_position_embeddings)


def _ffn(p: Params, hn, cfg: ArchConfig, rt: ModelRuntime) -> torch.Tensor:
    """A layer's feed-forward on its normed input: the MoE (by
    ``rt.moe_strategy``) where the layer has one, else its MLP."""
    if "moe" in p:
        return moe.apply_moe(p["moe"], hn, cfg, rt.moe_strategy)
    return apply_mlp(p["mlp"], hn, cfg.activation)


def _layer_apply(p: Params, x, cfg: ArchConfig, rt: ModelRuntime, positions) -> torch.Tensor:
    h = x + _mixer_apply(p, x, cfg, rt, positions)
    if "ln2" not in p:  # an SSM layer is its mixer alone
        return h
    return h + _ffn(p, apply_norm(p["ln2"], h, cfg.norm, cfg.norm_eps), cfg, rt)


def _shared_block_apply(p: Params, h, x0, inv: int, cfg: ArchConfig, rt: ModelRuntime,
                        positions, cache=None, writes=None) -> torch.Tensor:
    """The hybrid's shared block at invocation ``inv`` (the reference's
    ``_shared_block_apply``): on ``[h, x0]`` (width 2d), attention with
    ``wq`` offset by this invocation's LoRA product, then the MLP and the
    projection back to d; returns the delta to add to ``h``.  Without
    ``cache`` the attention runs over the full sequence; with ``cache =
    (k, v)`` (this invocation's dense slices) the ``writes`` tokens write
    their K/V in place and every query attends the cache, as a dense
    layer's decode or prefill does."""
    d2h = torch.cat([h, x0], dim=-1)
    xn = apply_norm(p["ln1"], d2h, cfg.norm, cfg.norm_eps)
    attn_p = p["attn"]
    if "lora_a" in p:  # merged in the parameters' dtype, as the reference merges
        wq = attn_p["wq"]
        attn_p = {**attn_p, "wq": wq + (p["lora_a"][inv] @ p["lora_b"][inv]).to(wq.dtype)}
    heads = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=2 * cfg.d_model // cfg.n_heads)
    if cache is None:
        a = _attn_forward(attn_p, xn, cfg, rt, positions=positions, **heads)
    else:
        a = _attn_dense_cache(attn_p, xn, cache[0], cache[1], positions, writes, cfg, **heads)
    y = d2h + a
    yn = apply_norm(p["ln2"], y, cfg.norm, cfg.norm_eps)
    y = y + apply_mlp(p["mlp"], yn, cfg.activation)
    return y @ p["down"]


class Model:
    def __init__(self, cfg: ArchConfig, runtime: Optional[ModelRuntime] = None):
        self.cfg = cfg
        self.rt = runtime or ModelRuntime()

    # ------------------------------------------------------------- init
    def init(self, seed: int, device=None) -> Params:
        """Random weights from ``numpy.random.default_rng(seed)`` with the
        reference's shapes and scales (``std = scale / sqrt(d_in)``,
        embeddings ``0.02``, output projections scaled by
        ``1 / sqrt(2 L)``).  The draws differ from ``jax.random``'s; parity
        tests share weights through ``models.weights.params_from_jax``."""
        device = resolve_device(device)
        dtype = self.rt.dtype
        rng = np.random.default_rng(seed)

        def normal(shape, std, dtype=dtype) -> torch.Tensor:
            a = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
            return torch.from_numpy(a).to(device=device, dtype=dtype)

        def const(shape, value) -> torch.Tensor:
            return torch.full(shape, float(value), dtype=dtype, device=device)

        def fp32(a) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        return self._param_tree(normal, const, fp32)

    def draw(self, generator: torch.Generator) -> Params:
        """Random weights drawn by ``generator`` on its own device (the
        card's generator draws on the card): the tree, shapes and scales of
        :meth:`init`, each normal leaf drawn straight into the model dtype
        there, with no host copy of it; the float32 leaves stay float32.
        The draws differ from :meth:`init`'s numpy ones."""
        device, dtype = generator.device, self.rt.dtype

        def normal(shape, std, dtype=dtype) -> torch.Tensor:
            return torch.empty(shape, dtype=dtype, device=device).normal_(
                0.0, std, generator=generator)

        def const(shape, value) -> torch.Tensor:
            return torch.full(shape, float(value), dtype=dtype, device=device)

        def fp32(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return self._param_tree(normal, const, fp32)

    def abstract_params(self) -> Params:
        """The parameter tree's shapes and dtypes as ``meta`` tensors,
        nothing allocated (the counterpart of ``jax.eval_shape(model.init)``)."""
        dtype = self.rt.dtype

        def empty(shape, _, dtype=dtype) -> torch.Tensor:
            return torch.empty(shape, dtype=dtype, device="meta")

        def fp32(a) -> torch.Tensor:
            return torch.empty(np.shape(a), dtype=torch.float32, device="meta")

        return self._param_tree(empty, empty, fp32)

    def _param_tree(self, normal, const, fp32) -> Params:
        """The parameter tree, each leaf made by ``normal(shape, std,
        dtype=None)``, ``const(shape, value)`` (both in the model dtype
        unless named) or ``fp32(array)`` (float32 whatever the model dtype)
        in a fixed order."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, hkv, vp = cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab
        depth_scale = 1.0 / math.sqrt(2 * cfg.n_layers)

        def dense(d_in, d_out, scale=1.0) -> torch.Tensor:
            return normal((d_in, d_out), scale / math.sqrt(d_in))

        def norm(width: int = d) -> Params:
            p = {"w": const((width,), 1.0)}
            if cfg.norm == "layernorm":
                p["b"] = const((width,), 0.0)
            return p

        def mlp(width: int, f: int = cfg.d_ff or cfg.moe_d_ff) -> Params:
            p = {"wi": dense(width, f)}
            if cfg.activation in GATED:
                p["wg"] = dense(width, f)
            p["wo"] = dense(f, width, depth_scale)
            return p

        def attn(bias: bool = cfg.qkv_bias) -> Params:
            p = {"wq": dense(d, h * hd), "wk": dense(d, hkv * hd), "wv": dense(d, hkv * hd),
                 "wo": dense(h * hd, d, depth_scale)}
            if bias:
                p.update(bq=const((h * hd,), 0.0), bk=const((hkv * hd,), 0.0),
                         bv=const((hkv * hd,), 0.0))
            return p

        n_dense = cfg.first_k_dense if cfg.family == "moe" else 0
        params: Params = {"embed": normal((vp, d), 0.02), "layers": []}
        for i in range(cfg.n_layers):
            if cfg.family in ("ssm", "hybrid"):
                params["layers"].append({
                    "ln1": norm(),
                    "mixer": ssm.mamba2_param_tree(cfg, normal, const, fp32, depth_scale)})
                continue
            a = mla.mla_param_tree(cfg, dense, norm, depth_scale) if cfg.use_mla else attn()
            layer = {"ln1": norm(), "attn": a, "ln2": norm()}
            if cfg.family == "moe" and i >= n_dense:
                layer["moe"] = moe.moe_param_tree(cfg, normal, mlp, depth_scale)
            else:
                layer["mlp"] = mlp(d)
            params["layers"].append(layer)
        if cfg.is_encoder_decoder:  # the reference's encoder and cross stacks
            params["encoder"] = {
                "layers": [{"ln1": norm(), "attn": attn(), "ln2": norm(), "mlp": mlp(d)}
                           for _ in range(cfg.n_encoder_layers)],
                "ln_f": norm(),
                "pos": normal((cfg.encoder_seq, d), 0.02),
            }
            params["cross"] = [{"ln": norm(), "attn": attn(bias=False)}
                               for _ in range(cfg.n_layers)]
        if cfg.max_position_embeddings:
            params["pos"] = normal((cfg.max_position_embeddings, d), 0.02)
        if cfg.family == "hybrid":  # the reference's _shared_block_init
            d2 = 2 * d
            hd2 = d2 // h
            shared = {
                "ln1": norm(d2),
                "attn": {"wq": dense(d2, h * hd2), "wk": dense(d2, hkv * hd2),
                         "wv": dense(d2, hkv * hd2), "wo": dense(h * hd2, d2, depth_scale)},
                "ln2": norm(d2),
                "mlp": mlp(d2),
                "down": dense(d2, d, depth_scale),
            }
            r = cfg.shared_attn_lora_rank
            if r:
                n_inv = cfg.n_layers // cfg.shared_attn_every
                shared["lora_a"] = normal((n_inv, d2, r), 1.0 / math.sqrt(d2))
                shared["lora_b"] = const((n_inv, r, h * hd2), 0.0)
            params["shared"] = shared
        params["ln_f"] = norm()
        if not cfg.tie_embeddings:
            params["lm_head"] = dense(d, vp)
        return params

    # ------------------------------------------------------------- forward
    def forward(self, params: Params, tokens: torch.Tensor,
                patches: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence causal forward: tokens ``(B, S)`` -> logits
        ``(B, S, Vp)`` float32; a VLM's ``patches`` ``(B, n_vision_tokens,
        d)`` go ahead of the tokens, and the logits are ``(B, n_vision_tokens
        + S, Vp)``; an encoder-decoder's decoder attends the encoder's
        output over ``frames`` ``(B, encoder_seq, d)``."""
        x = self._embed(params, tokens)
        if self.cfg.n_vision_tokens and patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        b, s = x.shape[:2]
        positions = on_mesh(torch.arange(s, device=tokens.device)[None].expand(b, s), x)
        if self.cfg.is_encoder_decoder:
            enc = self._encode(params, frames)
            return self._logits(params, self._run_decoder_with_cross(params, x, enc, positions))
        return self._logits(params, self._run_layers(params, x, positions))

    def _run_layers(self, params: Params, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
        """The decoder stack over ``x`` (the reference's ``_run_layers`` and
        ``_run_hybrid``), checkpointed by ``rt.remat``: in a hybrid each SSM
        layer alone and the shared block never; elsewhere the dense group
        and the rest apart, each in runs of ``remat_segment`` layers where
        that divides the group, else a layer at a time."""
        cfg, rt, layers = self.cfg, self.rt, params["layers"]
        h = x
        if cfg.family == "hybrid":
            for i, lp in enumerate(layers):
                inv = self._shared_at(i)
                if inv is not None:
                    h = h + _shared_block_apply(params["shared"], h, x, inv, cfg, rt, positions)
                h = self._apply_layers([lp], h, positions)
            return h
        n_dense = cfg.first_k_dense if cfg.family == "moe" else 0
        for group in (layers[:n_dense], layers[n_dense:]):
            seg = rt.remat_segment
            seg = seg if rt.remat and seg > 1 and len(group) % seg == 0 else 1
            for s in range(0, len(group), seg):
                h = self._apply_layers(group[s:s + seg], h, positions)
        return h

    def _apply_layers(self, lps: list, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """``lps`` in order over ``h``, as one checkpoint under ``rt.remat``:
        only ``h`` is kept for the backward, which runs them again."""

        def run(h):
            for lp in lps:
                h = _layer_apply(lp, h, self.cfg, self.rt, positions)
            return h

        return checkpoint(run, h, use_reentrant=False) if self.rt.remat else run(h)

    def _embed(self, params: Params, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings in the model dtype, plus the learned position
        table's rows where the model has one (the reference's ``_embed``
        and ``_embed_decode``): at ``positions`` ``(B, T)``, or from 0."""
        x = params["embed"][tokens]
        if self.cfg.max_position_embeddings:
            if positions is None:
                x = x + params["pos"][:tokens.shape[1]][None]
            else:
                x = x + params["pos"][positions]
        return shard(x.to(self.rt.dtype), "batch", "seq", "embed")

    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over the stub frontend's frame embeddings ``(B,
        encoder_seq, d)`` (the reference's ``_encode``): learned positions,
        non-causal self-attention without RoPE, the final norm."""
        cfg, enc = self.cfg, params["encoder"]
        x = frames.to(self.rt.dtype) + enc["pos"][None, :frames.shape[1]]
        positions = torch.arange(frames.shape[1], device=x.device)[None].expand(x.shape[:2])
        positions = on_mesh(positions, x)
        h = x
        for lp in enc["layers"]:
            hn = apply_norm(lp["ln1"], h, cfg.norm, cfg.norm_eps)
            h = h + _attn_forward(lp["attn"], hn, cfg, self.rt, positions=positions,
                                  causal=False, use_rope=False)
            h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg.norm, cfg.norm_eps),
                              cfg.activation)
        return apply_norm(enc["ln_f"], h, cfg.norm, cfg.norm_eps)

    def _run_decoder_with_cross(self, params: Params, x: torch.Tensor, enc: torch.Tensor,
                                positions: torch.Tensor) -> torch.Tensor:
        """The decoder's layers (the reference's ``_run_decoder_with_cross``):
        self-attention, then cross attention over ``enc``, then the MLP."""
        cfg, h = self.cfg, x
        for lp, cp in zip(params["layers"], params["cross"]):
            h = h + _mixer_apply(lp, h, cfg, self.rt, positions)
            h = h + _cross_forward(cp["attn"], apply_norm(cp["ln"], h, cfg.norm, cfg.norm_eps),
                                   enc, cfg, self.rt, positions)
            h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg.norm, cfg.norm_eps),
                              cfg.activation)
        return h

    def _shared_at(self, i: int) -> Optional[int]:
        """The invocation of the hybrid's shared block that runs before
        layer ``i``: one before each full segment of ``shared_attn_every``
        layers, none before the trailing layers past the last full
        segment (38 = 6 x 6 + 2 at zamba2-1.2b's depth); None for other
        families."""
        cfg = self.cfg
        if cfg.family != "hybrid":
            return None
        every = cfg.shared_attn_every
        inv, at = divmod(i, every)
        return inv if at == 0 and inv < cfg.n_layers // every else None

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """Next-token cross-entropy over ``batch`` (``tokens``, ``labels``,
        a VLM's ``patches``, an encoder-decoder's ``frames`` and an optional
        float ``loss_mask``); the patches' positions carry no label."""
        logits = self.forward(params, batch["tokens"], patches=batch.get("patches"),
                              frames=batch.get("frames"))
        if self.cfg.n_vision_tokens and "patches" in batch:
            logits = logits[:, self.cfg.n_vision_tokens:]
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones_like(ll)
        loss = -(ll * mask).sum() / mask.sum().clamp_min(1.0)
        return loss, {"loss": loss, "tokens": mask.sum()}

    def prefill(self, params: Params, tokens: torch.Tensor,
                patches: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill forward: the last position's logits ``(B, 1, Vp)``."""
        return self.forward(params, tokens, patches=patches, frames=frames)[:, -1:]

    # ------------------------------------------------------------- cache
    @property
    def supports_paged_cache(self) -> bool:
        """Whether this architecture's decode cache can be paged: an SSM's
        state is O(1) per slot (nothing to page), as in the reference."""
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid") or cfg.is_encoder_decoder:
            return False
        return cfg.sliding_window == 0

    @property
    def supports_fused_prefill(self) -> bool:
        """Whether ``prefill_chunk`` can ingest this architecture's prompts
        (the reference's rule: not for encoder-decoder, vision or MoE)."""
        cfg = self.cfg
        return not (cfg.is_encoder_decoder or cfg.n_vision_tokens or cfg.family == "moe")

    def init_cache(
        self,
        batch: int,
        max_len: int,
        *,
        paged: bool = False,
        page_size: int = 16,
        n_pages: Optional[int] = None,
        device=None,
    ) -> Params:
        """Decode cache, stacked over the layers.  Dense (the default): the
        SSM ``state`` (a hybrid's also ``shared_k``/``shared_v`` ``(n_inv,
        batch, max_len, Hkv, 2d / H)``) or ``k``/``v`` ``(L, batch, t, Hkv,
        hd)``, ``t = max_len`` without a sliding window, else the rolling
        ``min(max_len, pad128(window + 1))`` slots.
        MLA: ``c_kv`` ``(L, batch, max_len, r)`` and ``k_rope`` ``(L, batch,
        max_len, rope)``.  An encoder-decoder adds ``cross_k``/``cross_v``
        ``(L, batch, encoder_seq, Hkv, hd)``, zeros until a caller fills them
        from the encoder (the serving engine never does, as in the
        reference).
        ``paged=True``: ``k_pages``/``v_pages`` ``(L, n_pages, page_size,
        Hkv, hd)`` (MLA: ``kv_pages`` ``(L, n_pages, page_size, r +
        rope)``, a slot's latent and RoPE key side by side) and a
        ``page_table`` ``(batch, ceil(max_len / page_size))`` int32 whose
        entries hold the sentinel ``n_pages`` until the allocator backs
        them."""
        device = resolve_device(device)
        cfg, dtype = self.cfg, self.rt.dtype
        L = cfg.n_layers
        if not paged:
            if cfg.family in ("ssm", "hybrid"):
                one = ssm.mamba2_decode_state(cfg, batch, dtype, device)
                cache = {"state": {k: torch.zeros((L,) + v.shape, dtype=v.dtype, device=device)
                                   for k, v in one.items()}}
                if cfg.family == "hybrid":
                    shape = (L // cfg.shared_attn_every, batch, max_len, cfg.n_kv_heads,
                             2 * cfg.d_model // cfg.n_heads)
                    cache["shared_k"] = torch.zeros(shape, dtype=dtype, device=device)
                    cache["shared_v"] = torch.zeros(shape, dtype=dtype, device=device)
                return cache
            if cfg.use_mla:
                one = mla.mla_decode_cache(cfg, batch, max_len, dtype, "meta")
                return {k: torch.zeros((L,) + v.shape, dtype=dtype, device=device)
                        for k, v in one.items()}
            window = cfg.sliding_window  # rolling: the window + 1 slots, padded to 128
            t = max_len if window == 0 else min(max_len, -(-(window + 1) // 128) * 128)
            shape = (L, batch, t, cfg.n_kv_heads, cfg.resolved_head_dim)
            cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
            if cfg.is_encoder_decoder:
                shape = (L, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
                cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
                cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
            return cache
        if not self.supports_paged_cache:
            raise ValueError(
                f"paged cache unsupported for arch {cfg.name!r} "
                "(ssm/hybrid state, enc-dec cross cache, or rolling "
                "sliding-window cache)"
            )
        ps = int(page_size)
        pages_per_slot = -(-max_len // ps)
        pool = batch * pages_per_slot if n_pages is None else int(n_pages)
        cache = {"page_table": torch.full((batch, pages_per_slot), pool, dtype=torch.int32,
                                          device=device)}
        if cfg.use_mla:
            shape = (L, pool, ps, mla.mla_page_width(cfg))
            cache["kv_pages"] = torch.zeros(shape, dtype=dtype, device=device)
            return cache
        shape = (L, pool, ps, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["k_pages"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v_pages"] = torch.zeros(shape, dtype=dtype, device=device)
        return cache

    # ------------------------------------------------------------- steps
    def decode_step(
        self, params: Params, cache: Params, tokens: torch.Tensor, pos: torch.Tensor
    ) -> Tuple[torch.Tensor, Params]:
        """One token per row. tokens ``(B, 1)``; pos ``(B,)`` per-row cache
        positions (rows may be at different depths).  Returns logits
        ``(B, 1, Vp)``."""
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, device=tokens.device).long().expand(b)
        h = self._embed(params, tokens, pos[:, None])
        if "page_table" in cache:
            h = self._run_layers_paged(params, cache, h, pos[:, None], valid=None)
        elif self.cfg.family in ("ssm", "hybrid"):
            h = self._decode_ssm(params, cache, h, pos)
        else:
            h = self._decode_attn(params, cache, h, pos)
        return self._logits(params, h), cache

    def prefill_chunk(
        self,
        params: Params,
        cache: Params,
        tokens: torch.Tensor,  # (B, T) right-padded prompt chunks
        offsets: torch.Tensor,  # (B,) cache position of each row's first token
        lengths: torch.Tensor,  # (B,) valid tokens per row; 0 = inactive row
    ) -> Tuple[torch.Tensor, Params]:
        """Ingest whole prompt chunks in one dispatch; returns the logits of
        each row's last valid token ``(B, Vp)``."""
        b, T = tokens.shape
        lengths = lengths.long()
        h = self._prefill_hidden(params, cache, tokens, offsets, lengths)
        last = (lengths - 1).clamp(0, T - 1)
        h_last = h[torch.arange(b, device=h.device), last][:, None]  # (b, 1, d)
        return self._logits(params, h_last)[:, 0], cache

    def verify_chunk(
        self,
        params: Params,
        cache: Params,
        tokens: torch.Tensor,  # (B, T) right-padded [last accepted, k drafts]
        offsets: torch.Tensor,  # (B,) cache position of each row's first token
        lengths: torch.Tensor,  # (B,) valid tokens per row; 0 = inactive row
    ) -> Tuple[torch.Tensor, Params]:
        """Speculative-verify forward: the chunk-extend of
        :meth:`prefill_chunk`, returning every position's logits ``(B, T,
        Vp)``.  Position ``t``'s logits condition on the cache plus
        ``tokens[b, :t+1]``, what ``t + 1`` sequential decode steps would
        see; padded positions write nothing and their logits are garbage."""
        h = self._prefill_hidden(params, cache, tokens, offsets, lengths.long())
        return self._logits(params, h), cache

    def _prefill_hidden(self, params, cache, tokens, offsets, lengths) -> torch.Tensor:
        if self.cfg.is_encoder_decoder:  # the reference's refusal, message for message
            raise NotImplementedError(
                f"fused prefill unsupported for arch family {self.cfg.family!r} "
                "(enc-dec / vlm / moe)"
            )
        T = tokens.shape[1]
        ar = torch.arange(T, device=tokens.device)
        positions = offsets.long()[:, None] + ar[None, :]
        valid = ar[None, :] < lengths[:, None]
        h = params["embed"][tokens].to(self.rt.dtype)
        if "page_table" in cache:
            return self._run_layers_paged(params, cache, h, positions, valid=valid)
        if self.cfg.family in ("ssm", "hybrid"):
            return self._prefill_ssm(params, cache, h, positions, lengths, valid)
        return self._prefill_attn(params, cache, h, positions, valid)

    # ------------------------------------------------------------- layers
    def _decode_attn(self, params, cache, h, pos) -> torch.Tensor:
        return self._run_layers_dense(params, cache, h, pos[:, None], _every_row(h))

    def _prefill_attn(self, params, cache, h, positions, valid) -> torch.Tensor:
        """Only the valid tokens write (one host sync a dispatch)."""
        return self._run_layers_dense(params, cache, h, positions, nonzero(valid))

    def _run_layers_dense(self, params, cache, h, positions, writes) -> torch.Tensor:
        """The dense-cache layers; an encoder-decoder's decode adds each
        layer's cross attention over its cross cache (``_cross_decode``)."""
        cfg = self.cfg
        for i, lp in enumerate(params["layers"]):
            hn = apply_norm(lp["ln1"], h, cfg.norm, cfg.norm_eps)
            if cfg.use_mla:
                layer_cache = {"c_kv": cache["c_kv"][i], "k_rope": cache["k_rope"][i]}
                h = h + mla.apply_mla_extend(lp["attn"], hn, layer_cache, positions, cfg,
                                             writes)[0]
            else:
                h = h + _attn_dense_cache(lp["attn"], hn, cache["k"][i], cache["v"][i],
                                          positions, writes, cfg,
                                          use_rope=not cfg.max_position_embeddings)
            if cfg.is_encoder_decoder:
                cp = params["cross"][i]
                h = h + _cross_decode(cp["attn"], apply_norm(cp["ln"], h, cfg.norm, cfg.norm_eps),
                                      cache["cross_k"][i], cache["cross_v"][i], cfg)
            h = h + _ffn(lp, apply_norm(lp["ln2"], h, cfg.norm, cfg.norm_eps), cfg, self.rt)
        return h

    def _decode_ssm(self, params, cache, h, pos) -> torch.Tensor:
        """The SSM layers' recurrent step; a hybrid's shared block writes
        every row's K/V at ``pos % t`` (parked rows included, as the
        reference's decode does)."""
        cfg, state = self.cfg, cache["state"]
        writes = _every_row(h) if cfg.family == "hybrid" else None
        x0 = h
        for i, lp in enumerate(params["layers"]):
            inv = self._shared_at(i)
            if inv is not None:
                h = h + _shared_block_apply(
                    params["shared"], h, x0, inv, cfg, self.rt, pos[:, None],
                    cache=(cache["shared_k"][inv], cache["shared_v"][inv]), writes=writes)
            hn = apply_norm(lp["ln1"], h, cfg.norm, cfg.norm_eps)
            out, new = ssm.apply_mamba2_decode(lp["mixer"], hn,
                                               {k: v[i] for k, v in state.items()}, cfg)
            h = h + out
            for k, v in new.items():
                state[k][i].copy_(v)
        return h

    def _prefill_ssm(self, params, cache, h, positions, lengths, valid) -> torch.Tensor:
        """Each layer ingests the chunk from its cached state; on the card
        the scan goes through ``ops.ssd`` (``resolve_ssd``).  A hybrid's
        shared block writes the valid tokens' K/V only (one host sync a
        dispatch, as the dense layers' prefill)."""
        cfg, state = self.cfg, cache["state"]
        use_kernel = self.rt.resolve_ssd(device=h.device)
        writes = nonzero(valid) if cfg.family == "hybrid" else None
        x0 = h
        for i, lp in enumerate(params["layers"]):
            inv = self._shared_at(i)
            if inv is not None:
                h = h + _shared_block_apply(
                    params["shared"], h, x0, inv, cfg, self.rt, positions,
                    cache=(cache["shared_k"][inv], cache["shared_v"][inv]), writes=writes)
            hn = apply_norm(lp["ln1"], h, cfg.norm, cfg.norm_eps)
            out, new = ssm.apply_mamba2_prefill(
                lp["mixer"], hn, {k: v[i] for k, v in state.items()}, cfg, valid=valid,
                lengths=lengths, use_kernel=use_kernel)
            h = h + out
            for k, v in new.items():
                state[k][i].copy_(v)
        return h

    def _run_layers_paged(self, params, cache, h, positions, valid) -> torch.Tensor:
        cfg = self.cfg
        table = cache["page_table"]
        pool = cache["kv_pages" if cfg.use_mla else "k_pages"]
        n_pages, page_size = pool.shape[1], pool.shape[2]
        slots = write_slots(table, n_pages, page_size, positions, valid)
        for i, lp in enumerate(params["layers"]):
            hn = apply_norm(lp["ln1"], h, cfg.norm, cfg.norm_eps)
            if cfg.use_mla:
                h = h + mla.apply_mla_paged(lp["attn"], hn, pool[i], table, positions, cfg,
                                            slots)[0]
            else:
                h = h + self._attn_paged(lp["attn"], hn, cache["k_pages"][i],
                                         cache["v_pages"][i], table, positions, slots)
            h = h + _ffn(lp, apply_norm(lp["ln2"], h, cfg.norm, cfg.norm_eps), cfg, self.rt)
        return h

    def _attn_paged(self, p, x, k_pages, v_pages, table, positions, slots):
        cfg = self.cfg
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        b, T, _ = x.shape
        q, k, v = qkv_project(p, x, h, hkv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        rows, toks, pages, offs = slots
        write_at(k_pages, (pages, offs), k[rows, toks])
        write_at(v_pages, (pages, offs), v[rows, toks])
        out = ops.paged_attention(q, k_pages, v_pages, table, positions[:, 0],
                                  softcap=cfg.attn_logit_softcap)
        return out.reshape(b, T, h * hd) @ p["wo"]

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(params["ln_f"], h, cfg.norm, cfg.norm_eps)
        h = shard(h, "act_batch", "seq", "act_embed")
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return shard((h @ w).float(), "batch", "seq", "vocab")


def _every_row(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The writes of a decode dispatch on a dense cache: every row writes
    its one token (the reference's decode writes every row, parked ones
    included, at ``pos % t``)."""
    b = h.shape[0]
    return (on_mesh(torch.arange(b, device=h.device), h),
            on_mesh(torch.zeros(b, dtype=torch.long, device=h.device), h))


def write_slots(
    table: torch.Tensor,  # (B, P) int32
    n_pages: int,
    page_size: int,
    positions: torch.Tensor,  # (B, T) absolute positions
    valid: Optional[torch.Tensor],  # (B, T) real tokens, None = all
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(row, token, page, offset)`` of every K/V write a dispatch makes:
    the real tokens whose logical page is backed.  Parked rows (sentinel
    table entries) and padded tokens write nothing, not even into page 0.
    Computed once per dispatch (one host sync) and shared by every layer."""
    logical = (positions // page_size).clamp(max=table.shape[1] - 1)
    phys = table.long().gather(1, logical)  # (B, T)
    ok = (phys >= 0) & (phys < n_pages)
    if valid is not None:
        ok = ok & valid
    rows, toks = nonzero(ok)
    return rows, toks, phys[rows, toks], positions[rows, toks] % page_size
