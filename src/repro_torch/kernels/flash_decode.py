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

The kernel has three paths, chosen here by :func:`kernel_path` and
passed to the C entry, which refuses a path that does not apply (the
wrapper then raises; there is no fallback): calls with at most 8 folded
queries (``G*T <= 8``: decode, GQA decode up to G 8) and ``dk, dv`` in
{64, 128}, f32 or bf16, take the split-KV ``decode`` kernel (each row's
live pages shared out among the blocks :func:`decode_plan` counts, each
streaming its pages through a 2-stage ring of rounds, and the last block
of a (row, kv head) to finish merging the splits); bf16 chunk-extend with
``G*T >= 16`` and ``dk, dv`` in {64, 128} runs on the tensor cores
(``mma.sync`` over ``cp.async``-pipelined page tiles) up to the folded
queries its shared memory holds (:func:`tensor_core_rows`: 128, or 96 at
``dk = dv = 128``); every other call (f32 chunk-extend, MLA's 576/512,
odd widths, longer folds) runs the CUDA-core kernel.
Launches are counted in total (``launches``) and per path
(``launches_by_path``).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import math
import threading
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = ("cuda_core", "tensor_core", "decode")  # the C entry's `path` codes 0, 1 and 2
TENSOR_CORE_WIDTHS = (64, 128)
# The tensor-core path runs a warp per 16-row M-tile of folded queries (at
# most 8), each staging 32-key K and V units (rows padded by 8 elements) in
# its own 2-stage bf16 ring; the rings must fit an H100 block's opt-in
# shared memory, cudaDevAttrMaxSharedMemoryPerBlockOptin (csrc:
# tc_smem_bytes, run_tc)
TENSOR_CORE_MAX_TILES = 8
TENSOR_CORE_UNIT = 32
TENSOR_CORE_SMEM_BYTES = 232448
DECODE_WIDTHS = (64, 128)
DECODE_MAX_ROWS = 8  # folded queries a decode block computes
# The decode path's plan: a block loads its pages in rounds of K and V rows
# of at most DECODE_ROUND_BYTES (two rounds in flight); the grid aims at
# DECODE_BLOCKS_PER_SM blocks an SM while a split keeps DECODE_MIN_PAGES
# pages, and a split takes at most DECODE_MAX_ROUNDS rounds.  Measured with
# tools/kernel_variants.py on an H100 (bf16, B 16, Hkv 12, dk 64, page 16):
# 32 KiB rounds and 2 splits took 128-576 keys in 0.0223 ms, against
# 0.0238-0.0330 ms for 16 or 64 KiB rounds, 3 or 5 splits or one round a
# split; 5 splits of 7 rounds took 2048-4096 keys in 0.0856 ms, against
# 0.0970 and 0.1130 ms for 64 and 16 KiB rounds.
DECODE_ROUND_BYTES = 32 * 1024
DECODE_BLOCKS_PER_SM = 2
DECODE_MIN_PAGES = 4
DECODE_MAX_ROUNDS = 8


def tensor_core_rows(dk: int, dv: int) -> int:
    """The most folded queries the tensor-core path takes at widths ``dk``,
    ``dv``: 16 a warp, as many warps (at most 8) as have their K/V rings fit
    in shared memory: 128 at dk = dv = 64 and for the mixed widths, 96 at
    dk = dv = 128."""
    ring = 2 * TENSOR_CORE_UNIT * (dk + 8 + dv + 8) * 2  # two stages of bf16 K and V rows
    return 16 * min(TENSOR_CORE_MAX_TILES, TENSOR_CORE_SMEM_BYTES // ring)


def kernel_path(dtype: torch.dtype, ql: int, dk: int, dv: int) -> str:
    """Which of the kernel's paths takes a call: ``"decode"`` for at most 8
    folded queries (``ql = G*T``) with ``dk, dv`` in {64, 128}, f32 or bf16;
    ``"tensor_core"`` for bf16 with ``dk, dv`` in {64, 128} and from one
    16-row M-tile of folded queries up to :func:`tensor_core_rows`;
    ``"cuda_core"`` for every other call."""
    if ql <= DECODE_MAX_ROWS and dk in DECODE_WIDTHS and dv in DECODE_WIDTHS:
        return "decode"
    if (dtype == torch.bfloat16 and dk in TENSOR_CORE_WIDTHS and dv in TENSOR_CORE_WIDTHS
            and 16 <= ql <= tensor_core_rows(dk, dv)):
        return "tensor_core"
    return "cuda_core"


def decode_plan(batch: int, hkv: int, pages_per_slot: int, page_size: int, dk: int, dv: int,
                itemsize: int, sms: int) -> tuple:
    """``(splits, round_pages)`` of a decode-path call on a card of ``sms``
    SMs: the pages a block loads a round (K and V rows, each padded by 16
    bytes in shared memory, within ``DECODE_ROUND_BYTES``; at least one
    page, at most a split's), and how many blocks share a row's pages
    (``DECODE_BLOCKS_PER_SM`` blocks an SM where each keeps
    ``DECODE_MIN_PAGES`` pages, more where a split would take over
    ``DECODE_MAX_ROUNDS`` rounds; at most one a page)."""
    P = pages_per_slot
    page_bytes = page_size * ((dk + dv) * itemsize + 32)
    round_pages = max(1, min(P, DECODE_ROUND_BYTES // page_bytes))
    fill = min(-(-DECODE_BLOCKS_PER_SM * sms // (batch * hkv)), P // DECODE_MIN_PAGES)
    splits = max(1, min(max(fill, -(-P // (round_pages * DECODE_MAX_ROUNDS))), P))
    return splits, max(1, min(round_pages, -(-P // splits)))


@lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The decode path's f32 workspace and int32 counters, one pair per device,
# grown on demand (see paged_flash_attention_folded).  The lock makes the
# lookup and the growth one step: worker threads serving on one card at
# once would otherwise each grow the pair and one of them store a smaller
# buffer over a larger one another thread's shapes need.
_decode_scratch: dict = {}
_decode_lock = threading.Lock()


def _decode_buffers(device: torch.device, ws_floats: int, n_counters: int):
    with _decode_lock:
        ws, counters = _decode_scratch.get(device, (None, None))
        if ws is None or ws.numel() < ws_floats:
            ws = torch.empty(ws_floats, dtype=torch.float32, device=device)
        if counters is None or counters.numel() < n_counters:
            counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
        _decode_scratch[device] = (ws, counters)
        return ws, counters


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
    """Paged attention of folded queries (see the module docstring).

    On the ``decode`` path with more than one split, the splits' partial
    softmax states go to an f32 workspace and a per-(row, kv head) int32
    counter tells the last block of each to merge them; it resets the
    counter to 0.  Workspace and counters are one pair per device, kept
    here and reused by every call, so calls on one device must run on one
    stream (or be ordered between streams by the caller).  Threads may
    call at once: the pair is looked up and grown under a lock, and worker
    threads all launch on the device's default stream, which orders their
    kernels on the card."""
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
    splits, round_pages, ws_ptr, counters_ptr = 1, 1, None, None
    if path == "decode":
        splits, round_pages = decode_plan(b, hkv, page_table.shape[1], page_size, dk, dv,
                                          q.element_size(), _sm_count(q.device.index))
        if splits > 1:
            ws, counters = _decode_buffers(q.device, b * hkv * splits * ql * (dv + 2), b * hkv)
            ws_ptr, counters_ptr = ws.data_ptr(), counters.data_ptr()
    status = _build.library().paged_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        b, hkv, ql, dk, n_pages, page_size, page_table.shape[1], dv_store, dv,
        tokens_per_row, float(scale), float(softcap), PATHS.index(path), splits, round_pages,
        ws_ptr, counters_ptr, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, f"paged_attention_fwd ({path} path)")
    _build.count_launch(paged_flash_attention_folded, path)
    return out


paged_flash_attention_folded.launches = 0
paged_flash_attention_folded.launches_by_path = dict.fromkeys(PATHS, 0)
