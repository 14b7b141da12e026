"""Model-layout entry points for the kernels (counterpart of the
reference package's ``kernels/ops.py``).  Each folds its inputs into the
layout its kernel takes and unfolds the result; the kernel wrappers pick
the CUDA kernel or the plain version from the tensors' device.

A ``DTensor`` (the model run over a mesh, ``sharding.logical``) reaches
its kernel through ``local_map`` (``logical.local_call``): the operands
are laid out as the active rules say for their logical axes (heads on
``"model"``, the batch on the data axes), with the dimensions the kernel
reduces or scans over gathered, and each rank's kernel runs on its local
shard.  On a CUDA mesh that is the Hopper kernel, never its plain
version."""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.flash_decode import paged_flash_attention_folded
from repro_torch.kernels.ssd import blocked_cumsum, ssd_chunk, ssd_on_mesh
from repro_torch.sharding.logical import kernel_placements, local_call, partial_where_sharded, remap


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
    if isinstance(q, DTensor):  # each rank's kernel on its batch rows and heads
        pl = kernel_placements(q, ("batch", "seq", "heads", "head_dim"), whole=(1, 3))
        fn = functools.partial(flash_attention, causal=causal, sliding_window=sliding_window,
                               block_q=block_q, block_k=block_k)
        return local_call(fn, (q, k, v), (pl, pl, pl), pl)
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
    ``G*T`` query rows (``i = g*T + t``).  Over a mesh the rows (with
    their table rows and offsets) and the heads (query and KV heads
    together, where both divide) are split; the pool is read whole."""
    if isinstance(q, DTensor):
        return _paged_on_mesh(q, k_pages, v_pages, page_table, offsets, scale=scale,
                              softcap=softcap, v_width=v_width)
    return _fold_paged(paged_flash_attention_folded, q, k_pages, v_pages, page_table, offsets,
                       scale=scale, softcap=softcap, v_width=v_width)


def _paged_on_mesh(q, k_pages, v_pages, page_table, offsets, **kw) -> DTensor:
    hkv = k_pages.shape[2]
    sizes = q.device_mesh.shape
    pl = kernel_placements(q, ("cache_batch", None, "heads", None), whole=(1, 3))
    pl = [Replicate() if getattr(p, "dim", None) == 2 and hkv % sizes[i] else p
          for i, p in enumerate(pl)]
    pool = remap(pl, {2: 2})
    rows = remap(pl, {0: 0})
    fn = functools.partial(paged_attention, **kw)
    return local_call(fn, (q, k_pages, v_pages, page_table, offsets),
                      (pl, pool, pool, rows, rows), pl)


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
    """RMSNorm over the last axis of ``x`` (any leading shape).  Over a
    mesh each rank normalises its own rows, and ``w``'s gradient is summed
    over the ranks that split them."""
    if isinstance(x, DTensor):
        pl = kernel_placements(x, None, whole=(-1,))
        rep = [Replicate()] * len(pl)
        return local_call(functools.partial(rmsnorm, eps=eps), (x, w), (pl, rep), pl,
                          grad_placements=(pl, partial_where_sharded(pl)))
    shape = x.shape
    out = _rmsnorm.rmsnorm(x.reshape(-1, shape[-1]).contiguous(), w.contiguous(), eps)
    return out.reshape(shape)


def ssd(
    x: torch.Tensor,  # (b, l, h, p)
    dt: torch.Tensor,  # (b, l, h) float32, after softplus
    A: torch.Tensor,  # (h,) negative
    B: torch.Tensor,  # (b, l, n)
    C: torch.Tensor,  # (b, l, n)
    *,
    chunk: int = 128,
    block_h: int = 8,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: the Hopper within-chunk kernel (``ssd_chunk``) plus the
    inter-chunk recurrence and ``Y_off`` in plain torch, as the reference
    leaves them in jnp.  The contract of ``models.ssm.ssd_chunked``:
    returns ``(y (b, l, h, p) in x's dtype, final state (b, h, p, n)
    float32)``.  Over a mesh each rank scans its own batch rows and heads
    (``"ssm_heads"``)."""
    if isinstance(x, DTensor):
        return ssd_on_mesh(functools.partial(ssd, block_h=block_h), x, dt, A, B, C,
                           chunk=chunk, initial_state=initial_state)
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"seq {l} !% chunk {chunk}")
    nc = l // chunk
    if h % block_h:
        block_h = h  # degrade to one head block
    xr = x.reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h).float()
    dAr = (dt * A).reshape(b, nc, chunk, h).float()
    Br = B.reshape(b, nc, chunk, n)
    Cr = C.reshape(b, nc, chunk, n)
    y_diag, states = ssd_chunk(xr, dAr, dtr, Br, Cr, block_h=block_h)

    # inter-chunk recurrence over the (b, h, p, n) chunk states
    cum = blocked_cumsum(dAr, 2)  # (b, nc, q, h)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, h)
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    carry = initial_state.float()
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state entering chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)  # (b, nc, h, p, n)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cr.float(), prev) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p).to(x.dtype)
    return y, carry
