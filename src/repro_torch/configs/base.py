"""Architecture configs: the frozen :class:`ArchConfig`, the ``--arch``
registry and :func:`reduced` for CPU-sized tests.

A copy of the reference package's ``configs/base.py`` (the port keeps
its own: it imports nothing of the JAX package).  Field names, defaults
and derived properties are unchanged so a config means the same thing in
both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict

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
