"""Paged flash-decode / chunk-extend attention: the wrapper around the
hand-written Hopper kernel ``csrc/paged_attention.cu`` and its plain
PyTorch version.

Counterpart of the reference package's ``kernels/flash_decode.py``
(``paged_flash_attention_folded``), with the same folded layout
contract: callers fold queries group-major to ``(B, Hkv, G*T, dk)``
(fold index ``i = g*T + t``), query ``i`` of row ``b`` sits at absolute
position ``offsets[b] + i % T``, cache slot ``o`` of logical page ``j``
holds position ``j * page_size + o``, the mask is ``kv_pos <= q_pos``,
pages past the row's last query and table entries ``>= n_pages``
(unallocated) are skipped, and a query with nothing to attend yields
zeros.  ``v_width`` reads values from the first columns of a shared MLA
page; ``softcap`` applies ``tanh(s / softcap) * softcap`` to the scores.

The kernel has two paths, chosen here by :func:`kernel_path` and passed
to the C entry, which refuses a path that does not apply (the wrapper
then raises; there is no fallback): bf16 chunk-extend with ``G*T >= 16``
and ``dk, dv`` in {64, 128} runs on the tensor cores (``mma.sync`` over
``cp.async``-pipelined page tiles); every other call (f32, decode, GQA
decode, MLA's 576/512) runs the CUDA-core kernel.  Launches are counted
in total (``launches``) and per path (``launches_by_path``).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = ("cuda_core", "tensor_core")  # the C entry's `path` codes 0 and 1
TENSOR_CORE_WIDTHS = (64, 128)


def kernel_path(dtype: torch.dtype, ql: int, dk: int, dv: int) -> str:
    """Which of the kernel's paths takes a call: ``"tensor_core"`` for bf16
    with at least one 16-row M-tile of folded queries (``ql = G*T >= 16``,
    at most 8 tiles) and ``dk, dv`` in {64, 128}; ``"cuda_core"`` for every
    other call."""
    if (dtype == torch.bfloat16 and 16 <= ql <= 128 and dk in TENSOR_CORE_WIDTHS
            and dv in TENSOR_CORE_WIDTHS):
        return "tensor_core"
    return "cuda_core"


def paged_flash_attention_folded_plain(
    q: torch.Tensor,  # (B, Hkv, QL, dk)
    k_pages: torch.Tensor,  # (n_pages, page_size, Hkv, dk)
    v_pages: torch.Tensor,  # (n_pages, page_size, Hkv, dv_store)
    page_table: torch.Tensor,  # (B, P) int32
    offsets: torch.Tensor,  # (B,) int32
    *,
    tokens_per_row: int,
    scale: float,
    softcap: float = 0.0,
    v_width: int = 0,
) -> torch.Tensor:  # (B, Hkv, QL, dv)
    """Gather the row's pages, mask, softmax in fp32: what the kernel
    computes, written as plain tensor code."""
    b, hkv, ql, dk = q.shape
    n_pages, ps = k_pages.shape[0], k_pages.shape[1]
    P = page_table.shape[1]
    dv = v_width or v_pages.shape[-1]
    table = page_table.long()
    safe = table.clamp(0, n_pages - 1)
    k = k_pages[safe].reshape(b, P * ps, hkv, dk).float()
    v = v_pages[safe][..., :dv].reshape(b, P * ps, hkv, dv).float()
    s = torch.einsum("bhqd,bthd->bhqt", q.float(), k) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = offsets.long()[:, None] + torch.arange(ql, device=q.device) % tokens_per_row
    kv_pos = torch.arange(P * ps, device=q.device)
    alloc = torch.repeat_interleave((table >= 0) & (table < n_pages), ps, dim=1)
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) & alloc[:, None, :]  # (b, ql, t)
    mask = mask[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * mask  # nothing attendable -> zeros
    return torch.einsum("bhqt,bthd->bhqd", p, v).to(q.dtype)


def paged_flash_attention_folded(
    q: torch.Tensor,  # (B, Hkv, QL, dk) group-major fold, QL = G * T
    k_pages: torch.Tensor,  # (n_pages, page_size, Hkv, dk)
    v_pages: torch.Tensor,  # (n_pages, page_size, Hkv, dv_store)
    page_table: torch.Tensor,  # (B, P) int32; entries >= n_pages = unallocated
    offsets: torch.Tensor,  # (B,) int32 absolute position of the first query token
    *,
    tokens_per_row: int,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    v_width: int = 0,
) -> torch.Tensor:  # (B, Hkv, QL, dv)
    b, hkv, ql, dk = q.shape
    n_pages, page_size = k_pages.shape[0], k_pages.shape[1]
    dv_store = v_pages.shape[-1]
    dv = v_width or dv_store
    if ql % tokens_per_row:
        raise ValueError(f"QL {ql} must fold a whole group count x T {tokens_per_row}")
    if k_pages.shape[2] != hkv or k_pages.shape[3] != dk:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} does not match q {tuple(q.shape)}")
    if v_pages.shape[:3] != k_pages.shape[:3] or dv > dv_store:
        raise ValueError(f"v_pages {tuple(v_pages.shape)} / v_width {v_width} mismatch")
    if page_table.shape[0] != b or offsets.shape != (b,):
        raise ValueError("page_table / offsets batch does not match q")
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    tensors = (q, k_pages, v_pages, page_table, offsets)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_flash_attention_folded_plain(
            q, k_pages, v_pages, page_table, offsets, tokens_per_row=tokens_per_row,
            scale=scale, softcap=softcap, v_width=v_width,
        )
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged attention operands must all lie on one CUDA device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged attention takes float32 or bfloat16, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError("page_table and offsets must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention operands must be contiguous")
    if dv > 512:
        raise ValueError(f"value width {dv} exceeds the kernel's 512")
    out = torch.empty((b, hkv, ql, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    path = kernel_path(q.dtype, ql, dk, dv)
    status = _build.library().paged_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        b, hkv, ql, dk, n_pages, page_size, page_table.shape[1], dv_store, dv,
        tokens_per_row, float(scale), float(softcap), PATHS.index(path),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, f"paged_attention_fwd ({path} path)")
    paged_flash_attention_folded.launches += 1
    paged_flash_attention_folded.launches_by_path[path] += 1
    return out


paged_flash_attention_folded.launches = 0
paged_flash_attention_folded.launches_by_path = dict.fromkeys(PATHS, 0)
