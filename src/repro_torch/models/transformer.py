"""The dense decoder and the SSM (mamba2) family: full-sequence forward,
loss and the serving path on a paged or a dense (per-slot) cache.

Counterpart of the reference package's ``models/transformer.py`` for
the dense and SSM families:

    model = Model(cfg, ModelRuntime(dtype=torch.bfloat16))
    params = model.init(seed, device="cuda")
    logits = model.forward(params, tokens)              # (B, S, Vp)
    loss, metrics = model.loss(params, {"tokens": ..., "labels": ...})
    cache = model.init_cache(batch, max_len)            # dense, the default
    cache = model.init_cache(batch, max_len, paged=True, page_size=16, n_pages=N)
    logits, cache = model.decode_step(params, cache, tokens, pos)
    logits, cache = model.prefill_chunk(params, cache, tokens, offsets, lengths)

The full-sequence path chooses its attention by ``ModelRuntime``
(``resolve_attn``): ``direct`` (``layers.attention_scores``),
``chunked`` (online softmax over KV chunks in plain torch) or
``kernel`` (``ops.flash_attention``, the Hopper flash kernel, forward
only); an SSM layer chooses its scan by ``resolve_ssd``: the plain
``ssm.ssd_chunked`` or ``ops.ssd`` (the Hopper SSD chunk kernel, forward
only).  Layers run as a Python loop over the per-layer dicts (the
reference scans stacked layers); remat is not ported.

Parameters are a plain dict: ``embed`` ``(Vp, d)``, ``layers`` (a list,
one dict per layer: ``ln1``, ``attn`` {wq, wk, wv, wo}, ``ln2``, ``mlp``
{wi, wg, wo}; or for an SSM layer ``ln1`` and ``mixer``, see
``ssm.mamba2_param_tree``), ``ln_f`` and ``lm_head`` ``(d, Vp)``.

Caches are stacked over the layers and updated in place (the reference
returns a new cache pytree); both calls still return the cache so call
sites read alike.  The paged cache holds ``page_table``, ``k_pages`` and
``v_pages``; the dense cache ``k``/``v`` ``(L, B, max_len, Hkv, hd)`` for
the dense family and, for an SSM, ``state``: the conv windows ``(L, B,
k-1, c)`` in the model dtype and ``ssm`` ``(L, B, h, p, n)`` in fp32.
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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.models import ssm
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

Params = Dict[str, Any]
ATTN_IMPLS = ("auto", "direct", "chunked", "kernel")


@dataclass(frozen=True)
class ModelRuntime:
    """Execution knobs, orthogonal to the architecture (logits are always
    float32, the reference's default)."""

    dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"  # auto | direct | chunked | kernel
    attn_chunk: int = 1024
    use_ssd_kernel: Optional[bool] = None  # None = resolve_ssd's rule

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in {ATTN_IMPLS}")

    def resolve_attn(self, seq_len: int, *, device=None, grad: bool = False,
                     head_dim: int = 0) -> str:
        """The full-sequence attention implementation.  An explicit
        ``attn_impl`` is obeyed.  ``auto`` keeps the reference's rule
        (``direct`` up to 4096 tokens, else ``chunked``) on the CPU and
        wherever a gradient is taken; on a CUDA device with no gradient it
        takes the flash kernel where the kernel has the head width and the
        length fits its blocks, as the reference's ``resolve_paged_attn``
        picks its kernel on its own accelerator."""
        if self.attn_impl != "auto":
            return self.attn_impl
        on_card = device is not None and torch.device(device).type == "cuda"
        if on_card and not grad and flash.supports(seq_len, head_dim):
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
    ar = torch.arange(chunk, device=q.device)
    outs = []
    for iq in range(nq):
        qi = qs[iq]
        q_pos = iq * chunk + ar
        m = torch.full((b, h, chunk), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, chunk, hd), dtype=torch.float32, device=q.device)
        for jk in range(nq):
            k_pos = jk * chunk + ar
            logits = torch.einsum("bhqd,bhkd->bhqk", qi.float(), ks[jk].float()) * scale
            mask = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device)
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


def _attn_forward(p: Params, x: torch.Tensor, cfg: ArchConfig, rt: ModelRuntime, *,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal self-attention of one layer (the reference's
    ``_attn_forward`` for the dense family)."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    q, k, v = qkv_project(p, x, h, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kr, vr = repeat_kv(k, h), repeat_kv(v, h)
    impl = rt.resolve_attn(s, device=x.device, grad=q.requires_grad, head_dim=hd)
    if impl == "kernel":
        # as the reference's kernel branch, no logit softcap here
        out = ops.flash_attention(q, kr, vr, causal=True, sliding_window=cfg.sliding_window)
    elif impl == "chunked":
        out = chunked_attention(q, kr, vr, causal=True, sliding_window=cfg.sliding_window,
                                chunk=_pick_chunk(s, rt.attn_chunk))
    else:
        out = attention_scores(q, kr, vr, causal=True, sliding_window=cfg.sliding_window,
                               q_positions=positions, kv_positions=positions,
                               logit_softcap=cfg.attn_logit_softcap)
    return out.reshape(b, s, h * hd) @ p["wo"]


def _attn_dense_cache(p: Params, x, cache_k, cache_v, positions, writes, cfg: ArchConfig):
    """Decode or chunked prefill against a dense per-slot KV cache ``(B, t,
    Hkv, hd)`` (the reference's ``_attn_decode``/``_attn_extend``): the
    tokens ``writes = (rows, toks)`` write their K/V at ``position % t``, in
    place, and every query attends to the slots at or before its position;
    slot ``s`` holds ``last - ((last - s) mod t)``, the reference's
    reconstruction (the slot itself while the cache does not wrap; negative
    = never written)."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, T, _ = x.shape
    q, k, v = qkv_project(p, x, h, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    t = cache_k.shape[1]
    rows, toks = writes
    write = positions[rows, toks] % t
    cache_k[rows, write] = k[rows, toks].to(cache_k.dtype)
    cache_v[rows, write] = v[rows, toks].to(cache_v.dtype)
    last = positions[:, -1:]
    kv_pos = last - torch.remainder(last - torch.arange(t, device=x.device)[None, :], t)
    out = gqa_attention(q, cache_k, cache_v, q_positions=positions, kv_positions=kv_pos,
                        kv_mask=kv_pos >= 0, logit_softcap=cfg.attn_logit_softcap)
    return out.reshape(b, T, h * hd) @ p["wo"]


def _mixer_apply(p: Params, x, cfg: ArchConfig, rt: ModelRuntime, positions) -> torch.Tensor:
    xn = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    if "mixer" in p:
        use_kernel = rt.resolve_ssd(device=xn.device, grad=xn.requires_grad)
        return ssm.apply_mamba2(p["mixer"], xn, cfg, use_kernel=use_kernel)
    return _attn_forward(p["attn"], xn, cfg, rt, positions=positions)


def _layer_apply(p: Params, x, cfg: ArchConfig, rt: ModelRuntime, positions) -> torch.Tensor:
    h = x + _mixer_apply(p, x, cfg, rt, positions)
    if "ln2" not in p:  # an SSM layer is its mixer alone
        return h
    hn = apply_norm(p["ln2"], h, cfg.norm, cfg.norm_eps)
    return h + apply_mlp(p["mlp"], hn, cfg.activation)


class Model:
    def __init__(self, cfg: ArchConfig, runtime: Optional[ModelRuntime] = None):
        unsupported = [
            name for name, on in (
                (f"family {cfg.family!r}", cfg.family not in ("dense", "ssm")),
                ("MLA", cfg.use_mla),
                ("sliding-window attention", cfg.sliding_window > 0),
                ("encoder-decoder", cfg.is_encoder_decoder),
                ("vision tokens", cfg.n_vision_tokens > 0),
                ("learned positions", cfg.max_position_embeddings > 0),
            ) if on
        ]
        if unsupported:
            raise NotImplementedError(
                f"arch {cfg.name!r}: {', '.join(unsupported)} not ported yet "
                "(ROADMAP Queue 1: MLA paged, the hybrid family, the model zoo)"
            )
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

        def normal(shape, std) -> torch.Tensor:
            a = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
            return torch.from_numpy(a).to(device=device, dtype=dtype)

        def const(shape, value) -> torch.Tensor:
            return torch.full(shape, float(value), dtype=dtype, device=device)

        def fp32(a) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        return self._param_tree(normal, const, fp32)

    def abstract_params(self) -> Params:
        """The parameter tree's shapes and dtypes as ``meta`` tensors,
        nothing allocated (the counterpart of ``jax.eval_shape(model.init)``)."""
        dtype = self.rt.dtype

        def empty(shape, _) -> torch.Tensor:
            return torch.empty(shape, dtype=dtype, device="meta")

        def fp32(a) -> torch.Tensor:
            return torch.empty(np.shape(a), dtype=torch.float32, device="meta")

        return self._param_tree(empty, empty, fp32)

    def _param_tree(self, normal, const, fp32) -> Params:
        """The parameter tree, each leaf made by ``normal(shape, std)``,
        ``const(shape, value)`` (both in the model dtype) or ``fp32(array)``
        (float32 whatever the model dtype) in a fixed order."""
        cfg = self.cfg
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
        h, hkv, vp = cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab
        depth_scale = 1.0 / math.sqrt(2 * cfg.n_layers)

        def dense(d_in, d_out, scale=1.0) -> torch.Tensor:
            return normal((d_in, d_out), scale / math.sqrt(d_in))

        def norm() -> Params:
            p = {"w": const((d,), 1.0)}
            if cfg.norm == "layernorm":
                p["b"] = const((d,), 0.0)
            return p

        params: Params = {"embed": normal((vp, d), 0.02), "layers": []}
        for _ in range(cfg.n_layers):
            if cfg.family == "ssm":
                params["layers"].append({
                    "ln1": norm(),
                    "mixer": ssm.mamba2_param_tree(cfg, normal, const, fp32, depth_scale)})
                continue
            attn = {
                "wq": dense(d, h * hd), "wk": dense(d, hkv * hd), "wv": dense(d, hkv * hd),
                "wo": dense(h * hd, d, depth_scale),
            }
            if cfg.qkv_bias:
                attn.update(bq=const((h * hd,), 0.0), bk=const((hkv * hd,), 0.0),
                            bv=const((hkv * hd,), 0.0))
            mlp = {"wi": dense(d, f)}
            if cfg.activation in GATED:
                mlp["wg"] = dense(d, f)
            mlp["wo"] = dense(f, d, depth_scale)
            params["layers"].append({"ln1": norm(), "attn": attn, "ln2": norm(), "mlp": mlp})
        params["ln_f"] = norm()
        if not cfg.tie_embeddings:
            params["lm_head"] = dense(d, vp)
        return params

    # ------------------------------------------------------------- forward
    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward: tokens ``(B, S)`` -> logits
        ``(B, S, Vp)`` float32."""
        x = params["embed"][tokens].to(self.rt.dtype)
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        h = x
        for lp in params["layers"]:
            h = _layer_apply(lp, h, self.cfg, self.rt, positions)
        return self._logits(params, h)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """Next-token cross-entropy over ``batch`` (``tokens``, ``labels``
        and an optional float ``loss_mask``)."""
        logits = self.forward(params, batch["tokens"])
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones_like(ll)
        loss = -(ll * mask).sum() / mask.sum().clamp_min(1.0)
        return loss, {"loss": loss, "tokens": mask.sum()}

    def prefill(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Prefill forward: the last position's logits ``(B, 1, Vp)``."""
        return self.forward(params, tokens)[:, -1:]

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
        SSM ``state`` or ``k``/``v`` ``(L, batch, max_len, Hkv, hd)``.
        ``paged=True``: ``k_pages``/``v_pages`` ``(L, n_pages, page_size,
        Hkv, hd)`` and a ``page_table`` ``(batch, ceil(max_len /
        page_size))`` int32 whose entries hold the sentinel ``n_pages``
        until the allocator backs them."""
        device = resolve_device(device)
        cfg, dtype = self.cfg, self.rt.dtype
        L = cfg.n_layers
        if not paged:
            if cfg.family == "ssm":
                one = ssm.mamba2_decode_state(cfg, batch, dtype, device)
                return {"state": {k: torch.zeros((L,) + v.shape, dtype=v.dtype, device=device)
                                  for k, v in one.items()}}
            shape = (L, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
        if not self.supports_paged_cache:
            raise ValueError(
                f"paged cache unsupported for arch {cfg.name!r} "
                "(ssm/hybrid state, enc-dec cross cache, or rolling "
                "sliding-window cache)"
            )
        ps = int(page_size)
        pages_per_slot = -(-max_len // ps)
        pool = batch * pages_per_slot if n_pages is None else int(n_pages)
        shape = (L, pool, ps, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {
            "page_table": torch.full((batch, pages_per_slot), pool, dtype=torch.int32,
                                     device=device),
            "k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device),
        }

    # ------------------------------------------------------------- steps
    def decode_step(
        self, params: Params, cache: Params, tokens: torch.Tensor, pos: torch.Tensor
    ) -> Tuple[torch.Tensor, Params]:
        """One token per row. tokens ``(B, 1)``; pos ``(B,)`` per-row cache
        positions (rows may be at different depths).  Returns logits
        ``(B, 1, Vp)``."""
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, device=tokens.device).long().expand(b)
        h = params["embed"][tokens].to(self.rt.dtype)
        if "page_table" in cache:
            h = self._run_layers_paged(params, cache, h, pos[:, None], valid=None)
        elif self.cfg.family == "ssm":
            h = self._decode_ssm(params, cache, h)
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

    def _prefill_hidden(self, params, cache, tokens, offsets, lengths) -> torch.Tensor:
        T = tokens.shape[1]
        ar = torch.arange(T, device=tokens.device)
        positions = offsets.long()[:, None] + ar[None, :]
        valid = ar[None, :] < lengths[:, None]
        h = params["embed"][tokens].to(self.rt.dtype)
        if "page_table" in cache:
            return self._run_layers_paged(params, cache, h, positions, valid=valid)
        if self.cfg.family == "ssm":
            return self._prefill_ssm(params, cache, h, lengths, valid)
        return self._prefill_attn(params, cache, h, positions, valid)

    # ------------------------------------------------------------- layers
    def _decode_attn(self, params, cache, h, pos) -> torch.Tensor:
        """Every row writes its token (the reference's decode writes every
        row, parked ones included, at ``pos % t``)."""
        b = h.shape[0]
        writes = (torch.arange(b, device=h.device), torch.zeros(b, dtype=torch.long,
                                                                device=h.device))
        return self._run_layers_dense(params, cache, h, pos[:, None], writes)

    def _prefill_attn(self, params, cache, h, positions, valid) -> torch.Tensor:
        """Only the valid tokens write (one host sync a dispatch)."""
        return self._run_layers_dense(params, cache, h, positions, valid.nonzero(as_tuple=True))

    def _run_layers_dense(self, params, cache, h, positions, writes) -> torch.Tensor:
        cfg = self.cfg
        for i, lp in enumerate(params["layers"]):
            hn = apply_norm(lp["ln1"], h, cfg.norm, cfg.norm_eps)
            h = h + _attn_dense_cache(lp["attn"], hn, cache["k"][i], cache["v"][i], positions,
                                      writes, cfg)
            hn = apply_norm(lp["ln2"], h, cfg.norm, cfg.norm_eps)
            h = h + apply_mlp(lp["mlp"], hn, cfg.activation)
        return h

    def _decode_ssm(self, params, cache, h) -> torch.Tensor:
        cfg, state = self.cfg, cache["state"]
        for i, lp in enumerate(params["layers"]):
            hn = apply_norm(lp["ln1"], h, cfg.norm, cfg.norm_eps)
            out, new = ssm.apply_mamba2_decode(lp["mixer"], hn,
                                               {k: v[i] for k, v in state.items()}, cfg)
            h = h + out
            for k, v in new.items():
                state[k][i].copy_(v)
        return h

    def _prefill_ssm(self, params, cache, h, lengths, valid) -> torch.Tensor:
        """Each layer ingests the chunk from its cached state; on the card
        the scan goes through ``ops.ssd`` (``resolve_ssd``)."""
        cfg, state = self.cfg, cache["state"]
        use_kernel = self.rt.resolve_ssd(device=h.device)
        for i, lp in enumerate(params["layers"]):
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
        n_pages, page_size = cache["k_pages"].shape[1], cache["k_pages"].shape[2]
        slots = write_slots(table, n_pages, page_size, positions, valid)
        for i, lp in enumerate(params["layers"]):
            hn = apply_norm(lp["ln1"], h, cfg.norm, cfg.norm_eps)
            h = h + self._attn_paged(lp["attn"], hn, cache["k_pages"][i],
                                     cache["v_pages"][i], table, positions, slots)
            hn = apply_norm(lp["ln2"], h, cfg.norm, cfg.norm_eps)
            h = h + apply_mlp(lp["mlp"], hn, cfg.activation)
        return h

    def _attn_paged(self, p, x, k_pages, v_pages, table, positions, slots):
        cfg = self.cfg
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        b, T, _ = x.shape
        q, k, v = qkv_project(p, x, h, hkv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        rows, toks, pages, offs = slots
        k_pages[pages, offs] = k[rows, toks].to(k_pages.dtype)
        v_pages[pages, offs] = v[rows, toks].to(v_pages.dtype)
        out = ops.paged_attention(q, k_pages, v_pages, table, positions[:, 0],
                                  softcap=cfg.attn_logit_softcap)
        return out.reshape(b, T, h * hd) @ p["wo"]

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(params["ln_f"], h, cfg.norm, cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return (h @ w).float()


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
    rows, toks = ok.nonzero(as_tuple=True)
    return rows, toks, phys[rows, toks], positions[rows, toks] % page_size
