"""Architecture configs: the frozen :class:`ArchConfig`, the ``--arch``
registry, :func:`reduced` for CPU-sized tests, and the input-shape cells
(:data:`SHAPES`, :func:`cell_applicable`) the dry run and the roofline
read.

A copy of the reference package's ``configs/base.py`` (the port keeps
its own: it imports nothing of the JAX package).  Field names, defaults
and derived properties are unchanged so a config means the same thing in
both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

VOCAB_PAD_MULTIPLE = 2048  # same padding as the reference package


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # -- attention ---------------------------------------------------------
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 = full attention
    attn_logit_softcap: float = 0.0

    # -- mlp ----------------------------------------------------------------
    activation: str = "silu"  # silu (gated) | gelu (gated) | relu2 (ungated)

    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25

    # -- MLA (deepseek) ----------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # -- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_chunk: int = 128

    # -- hybrid (zamba2) ----------------------------------------------------------
    shared_attn_every: int = 0
    shared_attn_lora_rank: int = 0

    # -- encoder-decoder (whisper) ----------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0

    # -- vlm (internvl2) ----------------------------------------------------------
    n_vision_tokens: int = 0

    # -- misc ---------------------------------------------------------------------
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_position_embeddings: int = 0  # 0 = rope (unbounded); >0 = learned

    source: str = ""  # provenance tag

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def uses_subquadratic_attention(self) -> bool:
        """Can this arch run 500k-token decode?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    # -- parameter counting (for MODEL_FLOPS and the roofline) --------------------
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)

    def flops_per_token(self, seq_len: int, *, decode: bool = False) -> float:
        """Model FLOPs per token: 6N for train, 2N for a decode step, plus
        attention score/value terms (which 6N misses)."""
        n = self.active_param_count()
        mult = 2.0 if decode else 6.0
        flops = mult * n
        # attention O(S) term per token: 2*2*H*hd*S_kv (scores + values), x3 for bwd
        if self.family != "ssm":
            s_kv = seq_len
            if self.sliding_window:
                s_kv = min(seq_len, self.sliding_window)
            attn_layers = self.n_layers
            if self.shared_attn_every:
                attn_layers = self.n_layers // self.shared_attn_every
            h = self.n_heads
            hd = self.resolved_head_dim
            if self.use_mla:
                hd = self.nope_head_dim + self.rope_head_dim
            per_tok = 2 * 2 * h * hd * (s_kv if decode else s_kv / 2) * attn_layers
            flops += per_tok * (1.0 if decode else 3.0)
        return flops


def _param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """The reference's parameter count, term for term (embeddings padded to
    ``padded_vocab``; a MoE's routed experts all, or ``top_k`` of them with
    ``active_only``)."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hd = cfg.resolved_head_dim
    total = V * D  # embed
    if not cfg.tie_embeddings:
        total += D * V  # lm_head

    def attn_params() -> int:
        if cfg.use_mla:
            p = D * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * (
                cfg.nope_head_dim + cfg.rope_head_dim
            )
            p += D * (cfg.kv_lora_rank + cfg.rope_head_dim)
            p += cfg.kv_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)
            p += cfg.n_heads * cfg.v_head_dim * D
            return p
        q = D * cfg.n_heads * hd
        kv = 2 * D * cfg.n_kv_heads * hd
        o = cfg.n_heads * hd * D
        b = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
        return q + kv + o + b

    def mlp_params(f: int) -> int:
        gated = cfg.activation in ("silu", "gelu_gated")
        return (3 if gated else 2) * D * f

    def ssm_params() -> int:
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
        in_proj = D * (2 * di + 2 * n + h)  # z, x, B, C, dt
        conv = (di + 2 * n) * cfg.ssm_conv
        out = di * D
        extra = 3 * h + di  # A_log, D, dt_bias, norm
        return in_proj + conv + out + extra

    if cfg.family == "ssm":
        total += cfg.n_layers * ssm_params()
    elif cfg.family == "hybrid":
        total += cfg.n_layers * ssm_params()
        n_inv = cfg.n_layers // max(cfg.shared_attn_every, 1)
        total += attn_params() + mlp_params(F)  # weights are shared across invocations
        if cfg.shared_attn_lora_rank:
            total += n_inv * (2 * D * cfg.shared_attn_lora_rank)  # per-invocation LoRA on wq
    elif cfg.family == "moe":
        dense_ff = mlp_params(F) if F else 0
        experts = cfg.n_experts * mlp_params(cfg.moe_d_ff) + D * cfg.n_experts
        shared = cfg.n_shared_experts * mlp_params(cfg.moe_d_ff)
        active_experts = cfg.top_k * mlp_params(cfg.moe_d_ff) + D * cfg.n_experts
        for layer in range(cfg.n_layers):
            per = attn_params()
            if layer < cfg.first_k_dense:
                per += dense_ff
            else:
                per += (active_experts if active_only else experts) + shared
            total += per
    else:  # dense / audio / vlm
        total += cfg.n_layers * (attn_params() + mlp_params(F))
        if cfg.is_encoder_decoder:
            # encoder layers + decoder cross-attention
            total += cfg.n_encoder_layers * (attn_params() + mlp_params(F))
            total += cfg.n_layers * attn_params()  # cross-attn per decoder layer
    return int(total)


# ---------------------------------------------------------------- input shapes
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | serve_prefill | serve_decode | serve_paged


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
    # the serving engine's hot paths: chunked prefill writing the decode
    # cache in one dispatch, ragged decode (per-row positions [B], one
    # dispatch a tick) and the same decode against the paged cache (a
    # shared page pool half the dense reservation plus a page table)
    "serve_prefill_32k": ShapeSpec("serve_prefill_32k", 32_768, 32, "serve_prefill"),
    "serve_ragged_32k": ShapeSpec("serve_ragged_32k", 32_768, 128, "serve_decode"),
    "serve_paged_32k": ShapeSpec("serve_paged_32k", 32_768, 128, "serve_paged"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is (arch x shape) a runnable cell?  The reference's skip rules,
    message for message."""
    if shape.name == "long_500k" and not cfg.uses_subquadratic_attention:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    if shape.kind == "serve_prefill":
        # mirror Model.supports_fused_prefill + the rolling-cache gate
        if cfg.is_encoder_decoder or cfg.n_vision_tokens:
            return False, "serve_prefill skipped: side inputs (enc-dec/vlm)"
        if cfg.family == "moe":
            return False, "serve_prefill skipped: MoE capacity is batch-shaped"
        if cfg.sliding_window:
            return False, "serve_prefill skipped: rolling sliding-window cache"
    if shape.kind == "serve_paged":
        # mirror Model.supports_paged_cache
        if cfg.family in ("ssm", "hybrid"):
            return False, "serve_paged skipped: O(1) recurrent state, nothing to page"
        if cfg.is_encoder_decoder:
            return False, "serve_paged skipped: static enc-dec cross cache"
        if cfg.sliding_window:
            return False, "serve_paged skipped: rolling sliding-window cache"
    return True, ""


# ---------------------------------------------------------------------- registry
_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_arch(name: str) -> ArchConfig:
    from repro_torch import configs as _c  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    from repro_torch import configs as _c  # noqa: F401  (populates the registry)

    return sorted(_REGISTRY)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU tests (the reference package's
    ``reduced``): 2 layers, d_model 64, vocab 256; 4 query heads over at
    most 2 KV heads of 16, or SSM state 16, head width 16 and chunk 16; a
    MoE has 4 experts of width 64, top-k at most 2, at most 1 shared
    expert and 1 dense layer; MLA has a latent of rank 32 (queries 48),
    RoPE keys of 8, no-RoPE and value heads of 16; a hybrid has 4 layers
    with the shared block every 2 and a LoRA rank of at most 8; an
    encoder-decoder 2 encoder layers over 32 frames; a VLM 8 vision
    tokens; a sliding window becomes 32; learned positions 512."""
    small: Dict = dict(
        n_layers=max(2, cfg.shared_attn_every or 0) * 2 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16 if cfg.n_heads else 0,
    )
    if cfg.family == "moe":
        small.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=64,
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.use_mla:
        small.update(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                     nope_head_dim=16, v_head_dim=16, head_dim=0)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16, d_model=64)
    if cfg.shared_attn_every:
        small.update(shared_attn_every=2, n_layers=4,
                     shared_attn_lora_rank=min(cfg.shared_attn_lora_rank, 8))
    if cfg.is_encoder_decoder:
        small.update(n_encoder_layers=2, encoder_seq=32)
    if cfg.n_vision_tokens:
        small.update(n_vision_tokens=8)
    if cfg.sliding_window:
        small.update(sliding_window=32)
    if cfg.max_position_embeddings:
        small.update(max_position_embeddings=512)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
