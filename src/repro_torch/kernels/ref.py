"""Plain-PyTorch oracles for every kernel entry point in ``kernels.ops``
(the allclose targets), in the model layout of the reference package's
``kernels/ref.py``.  Each is its op with the kernel's plain version in
place of the kernel: one plain version per kernel, kept beside it."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_bhsd_plain
from repro_torch.kernels.flash_decode import paged_flash_attention_folded_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.ssd import ssd_chunk_plain

# Direct softmax attention with causal/sliding-window masking in the
# folded ``(BH, S, hd)`` layout, the reference's ``attention_reference``.
attention_reference = flash_attention_bhsd_plain


def flash_attention_reference(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, H, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int = 0,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Model-layout oracle for ``ops.flash_attention`` (the blocks only
    shape the kernel's contract, not its result)."""
    return ops._fold_flash(flash_attention_bhsd_plain, q, k, v, causal=causal,
                           sliding_window=sliding_window)


def paged_attention_reference(
    q: torch.Tensor,  # (B, T, H, dk)
    k_pages: torch.Tensor,  # (n_pages, page_size, Hkv, dk)
    v_pages: torch.Tensor,  # (n_pages, page_size, Hkv, dv_store)
    page_table: torch.Tensor,  # (B, P) int; entries >= n_pages = unallocated
    offsets: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    v_width: int = 0,
) -> torch.Tensor:
    """Gather-then-softmax oracle for the paged flash kernel: unallocated
    pages and future positions are masked, and queries with nothing
    attendable return zeros."""
    return ops._fold_paged(paged_flash_attention_folded_plain, q, k_pages, v_pages, page_table,
                           offsets, scale=scale, softcap=softcap, v_width=v_width)


rmsnorm_reference = rmsnorm_plain  # any leading shape: it normalises the last axis

# The within-chunk term and per-chunk states (the kernel's contract):
# x (b, nc, q, h, p); dA/dt (b, nc, q, h); B/C (b, nc, q, n) ->
# (Y_diag (b, nc, q, h, p), states (b, nc, h, p, n)), float32.
ssd_chunk_reference = ssd_chunk_plain


def ssd_reference(
    x: torch.Tensor,  # (b, l, h, p)
    dt: torch.Tensor,  # (b, l, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, l, n)
    C: torch.Tensor,  # (b, l, n)
    chunk: int,
    *,
    initial_state: Optional[torch.Tensor] = None,
):
    """Full chunked-SSD oracle for ``ops.ssd``, shared with the model's
    plain path (``models.ssm.ssd_chunked``), as in the reference."""
    from repro_torch.models.ssm import ssd_chunked

    return ssd_chunked(x, dt, A, B, C, chunk, initial_state=initial_state)


# Op name -> plain oracle for every public entry point in ``kernels.ops``;
# a test keeps it total.  ``paged_verify`` shares ``paged_attention``'s
# oracle: the verify primitive is the chunk-extend case (T = k + 1).
ORACLES = {
    "flash_attention": flash_attention_reference,
    "paged_attention": paged_attention_reference,
    "paged_verify": paged_attention_reference,
    "ssd": ssd_reference,
    "rmsnorm": rmsnorm_reference,
}
