"""Model-layout entry points for the kernels (counterpart of the
reference package's ``kernels/ops.py``).  Each folds its inputs into the
layout its kernel takes and unfolds the result; the kernel wrappers pick
the CUDA kernel or the plain version from the tensors' device."""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.flash_decode import paged_flash_attention_folded


def _fold_flash(attend: Callable, q, k, v, *, causal: bool, sliding_window: int) -> torch.Tensor:
    """Fold model-layout heads into the batch (``(B*H, S, hd)``), run
    ``attend`` (the kernel wrapper or its plain version) and unfold."""
    b, s, h, hd = q.shape

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], hd)

    out = attend(fold(q), fold(k), fold(v), causal=causal, window=sliding_window)
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd) model layout
    k: torch.Tensor,  # (B, S, H, hd), KV heads already repeated to H
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int = 0,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:  # (B, S, H, hd)
    """Full-sequence flash attention; the sequence must divide
    ``min(block, S)`` (the reference's block contract)."""
    attend = functools.partial(flash_attention_bhsd, block_q=block_q, block_k=block_k)
    return _fold_flash(attend, q, k, v, causal=causal, sliding_window=sliding_window)


def _fold_paged(attend: Callable, q, k_pages, v_pages, page_table, offsets, *,
                scale: Optional[float], softcap: float, v_width: int) -> torch.Tensor:
    """Fold model-layout queries group-major, run ``attend`` (the kernel
    wrapper or its plain version) on the folded layout and unfold."""
    b, T, h, dk = q.shape
    hkv = k_pages.shape[2]
    g = h // hkv
    qf = q.reshape(b, T, hkv, g, dk).permute(0, 2, 3, 1, 4).reshape(b, hkv, g * T, dk)
    out = attend(
        qf.contiguous(), k_pages, v_pages, page_table.to(torch.int32),
        offsets.to(torch.int32), tokens_per_row=T,
        scale=1.0 / math.sqrt(dk) if scale is None else scale, softcap=softcap,
        v_width=v_width,
    )  # (B, Hkv, G*T, dv)
    dv = out.shape[-1]
    return out.reshape(b, hkv, g, T, dv).permute(0, 3, 1, 2, 4).reshape(b, T, h, dv)


def paged_attention(
    q: torch.Tensor,  # (B, T, H, dk) model layout, RoPE already applied
    k_pages: torch.Tensor,  # (n_pages, page_size, Hkv, dk)
    v_pages: torch.Tensor,  # (n_pages, page_size, Hkv, dv_store)
    page_table: torch.Tensor,  # (B, P) int32; entries >= n_pages = unallocated
    offsets: torch.Tensor,  # (B,) absolute position of each row's first token
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    v_width: int = 0,
) -> torch.Tensor:  # (B, T, H, dv)
    """Flash-decode (``T = 1``) / chunk-extend (``T > 1``) against a paged
    KV cache.  Grouped-query layout: KV heads are not repeated; the ``G``
    query heads of a KV head are folded group-major into one block of
    ``G*T`` query rows (``i = g*T + t``)."""
    return _fold_paged(paged_flash_attention_folded, q, k_pages, v_pages, page_table, offsets,
                       scale=scale, softcap=softcap, v_width=v_width)


def paged_verify(
    q: torch.Tensor,  # (B, k+1, H, dk): last accepted token + k draft tokens
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    offsets: torch.Tensor,  # (B,) each row's write frontier
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    v_width: int = 0,
) -> torch.Tensor:
    """Speculative verify: score ``k + 1`` candidate positions per row in
    one launch.  This is :func:`paged_attention`'s chunk-extend case
    (``T = k + 1``); the causal mask scopes each draft to the accepted
    history plus the drafts before it.  Kept as a named entry so call
    sites can say *verify*; the dispatch is shared."""
    return paged_attention(
        q, k_pages, v_pages, page_table, offsets,
        scale=scale, softcap=softcap, v_width=v_width,
    )


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (any leading shape)."""
    shape = x.shape
    out = _rmsnorm.rmsnorm(x.reshape(-1, shape[-1]).contiguous(), w.contiguous(), eps)
    return out.reshape(shape)
