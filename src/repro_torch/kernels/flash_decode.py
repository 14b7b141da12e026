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
of a (row, kv head) to finish merging the splits); ``dk, dv`` in {64, 128}
from ``TENSOR_CORE_MIN_ROWS`` folded queries up, ``dk = dv = 192`` at
every fold, and MLA's ``dk 576 / dv 512`` with one latent pool passed as K
and V at any fold run on the tensor cores (``mma.sync``), bf16 and f32
alike, f32 in 3xTF32 (every operand split into TF32 hi and lo, three
products a pass): the fold is cut into row groups of at most 8 M-tiles of
16 rows (4 at dk 192 in f32, whose kernel keeps the group's Q in shared
memory; 4 at MLA's fold in bf16, 2 in f32, each M-tile there taking 4
warps, each a quarter of S's depth and of O's columns), a block's warps
share one ``cp.async`` ring of K/V units (MLA's values read from the
first 512 columns of the staged latent), so a block reads the row's K/V
once, and where the grid would leave most SMs idle the row's keys are
shared out among blocks that merge as the decode path's do, or at MLA's
widths in a thread-block cluster (:func:`tensor_core_plan`); every other
call (576/512 with separate K and V pools, odd widths) runs the CUDA-core
kernel.  So the f32 folds that took the CUDA cores before the f32
tensor-core route (parity's chunk-extend, verify from T 9, the zoo's
folds) take the tensor cores; f32 folds of up to 8 rows keep the decode
path.
Launches are counted in total (``launches``) and per path
(``launches_by_path``).

A tensor on the CPU (or the meta device: the dry run) takes the plain
version; a CUDA tensor launches the
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
# The tensor-core path's (dk, dv), and the least fold it takes at the
# widths the decode path also takes, in either dtype (it takes every fold
# at 192).  Measured with tools/kernel_variants.py (tc) on an H100 (B 16,
# 128-576 keys): at 9-15 bf16 rows (G 1, Hkv 12, dk 64) it took
# 0.0225-0.0235 ms against the CUDA-core path's 0.0677-0.0810.  It also
# beat the decode path at 5 and 8 rows (0.0217 / 0.0220 ms against 0.0424
# / 0.0436) and at 8 rows of dk 128 (0.0288 against 0.0605).  In f32
# (3xTF32; tc_f32, NVIDIA H100 80GB HBM3, 700.00 W) it took verify T 9 in
# 0.04102 ms against 0.07229, 12 and 16 rows in 0.04163 / 0.0416 against
# 0.0729 / 0.08605, G 8 x T 5 at dk 128 in 0.09469 against 0.2513, and
# the smallest f32 calls served: ds-paper-100m's spec_parity verify T 9 (B
# 4, 8 pages a slot) in 0.01773 against 0.01907 and parity's chunk-extend
# (B 4, T 16) in 0.01846 against 0.02422, so no f32 fold from 9 rows stays
# on the CUDA cores; at 8 rows of dk 128 (qwen2-72b's G 8 decode) it took
# 0.08179 against the decode path's 0.1070.  The decode path keeps its
# folds of up to 8 in both dtypes for now (ROADMAP Queue 2).
TENSOR_CORE_WIDTHS = ((64, 64), (64, 128), (128, 64), (128, 128), (192, 192), (576, 512))
TENSOR_CORE_MIN_ROWS = 9
# MLA's fold (csrc/paged_mla.cu): one latent pool as K and V, values its
# first 512 columns; a block takes a row group of at most MLA_MAX_TILES
# M-tiles (its Q rows staged in shared memory, 4 warps an M-tile).  A row's
# key splits merge as one thread-block cluster, so at most MLA_MAX_SPLITS,
# and the card holds fewer blocks at once in clusters (117, 120, 110, 102,
# 105, 120 of 132 in clusters of 3-8, cudaOccupancyMaxActiveClusters): the
# splits fill at most MLA_FILL of the SMs.  Measured with
# tools/kernel_variants.py (mla) on an H100 (NVIDIA H100 80GB HBM3,
# 700.00 W; bf16, B 16, G 128, 128-576 keys): 64-row groups in 3 splits
# took the decode in 0.03571 ms, against 0.03818 in 4 (30 clusters of 4
# fit at once, the grid needs 32), 0.04512 in 2 and 0.07341 unsplit, and
# 32-row groups in 2 splits 0.03610; 2 warps an M-tile took 0.03629 (the
# T 4 fold 0.07562 against 0.07565), each warp computing S whole 0.05098
# (0.1184), and merging the splits through the f32 workspace by the last
# block (as the other widths do) 0.04810 against 0.03584 in a cluster.
MLA_WIDTHS = (576, 512)
MLA_MAX_TILES = 4
MLA_MAX_SPLITS = 8
MLA_FILL = 0.75
# The f32 fold (3xTF32): its Q and latent units take twice the bytes, so
# a block takes at most MLA_F32_MAX_TILES M-tiles (csrc/paged_mla.cu: Q
# of 32 rows, 3 stages of 16-key units), and its splits fill MLA_F32_FILL
# of the SMs.  Measured with tools/kernel_variants.py (mla) on an H100
# (NVIDIA H100 80GB HBM3, 700.00 W; f32, B 16, G 128, 146-518 keys a row):
# 32-row groups in 3 splits took the decode in 0.08010 ms, against 0.08579
# in 2, 0.08413 in 4 and 0.1522 unsplit (the T 4 fold 0.2189 unsplit,
# 0.2157 in 2), and 16-row groups 0.1293 (in their best plan, 2 splits,
# 0.1092); 32-key units (which fit beside 16 rows only) 0.1244, 8 warps an
# M-tile 0.08032, 2 warps 0.09434, 2 ring stages 0.08102, S's three
# products in one accumulator 0.08442, four accumulators 0.08058.
MLA_F32_MAX_TILES = 2
MLA_F32_FILL = 1.5
# A block of the tensor-core path takes a row group of at most
# TENSOR_CORE_MAX_TILES 16-row M-tiles, a warp each, and walks the row's
# keys in units of TENSOR_CORE_UNIT (csrc/paged_tensor_core.cu: tc_block
# lays the block out, run_tc refuses a plan that does not fit; the CPU
# tests mirror its shared-memory budget).  The plan shares a row's units
# out among blocks while the grid holds under TENSOR_CORE_BLOCKS_PER_SM
# blocks an SM, each keeping TENSOR_CORE_MIN_UNITS units, at most
# TENSOR_CORE_MAX_SPLITS of them (the last block of a row merges them
# all).  Measured with tools/kernel_variants.py (tc) on an H100 (bf16,
# B 16, 128-576 keys): a 200 KiB ring took nemotron-4-340b's decode in
# 0.0403 ms against 0.0574 at 112 KiB; granite-34b's MQA decode took
# 0.0207 ms in 8 key splits, against 0.0407 unsplit, 0.0313 in 4, 0.0259
# in 16 and 0.0259 in 3 row groups of one M-tile and 2 splits; one MQA
# row of 4096 keys took 0.0366 ms in 16 splits against 0.0548 in 64.
TENSOR_CORE_MAX_TILES = 8
# An f32 block stages its group's Q in shared memory beside a ring of
# twice the bytes (csrc/paged_tensor_core.cu), so its group's cap is set
# by dk: TENSOR_CORE_F32_MAX_TILES[dk].  Measured with
# tools/kernel_variants.py (tc_f32) on an H100 (NVIDIA H100 80GB HBM3,
# 700.00 W; f32, B 16, page 16, prefill offsets 0-496): nemotron-4-340b's
# prefill (12 M-tiles at 192) took 0.2277 ms in 3 groups of 4 against
# 0.2528 in 2 of 6 (3 ring stages either way); granite-34b's 768 rows
# 0.1060 in 8 groups of 6 against 0.1064 in 6 of 8 and 0.1156 in 12 of 4;
# qwen2-72b's 128 rows at 128 0.1076 in one group of 8 against 0.1372 in
# 2 of 4.  The f32 plan's key splits are the bf16 plan's: granite's MQA
# decode took 0.03018 ms in 8 splits against 0.03638 in 16, 0.04774 in 4
# and 0.08563 unsplit.
TENSOR_CORE_F32_MAX_TILES = {64: 8, 128: 8, 192: 4}
TENSOR_CORE_UNIT = 32
TENSOR_CORE_BLOCKS_PER_SM = 1
TENSOR_CORE_MIN_UNITS = 2
TENSOR_CORE_MAX_SPLITS = 16
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


def kernel_path(dtype: torch.dtype, ql: int, dk: int, dv: int, *,
                shared_pool: bool = True) -> str:
    """Which of the kernel's paths takes a call: ``"tensor_core"`` at
    ``MLA_WIDTHS`` in either dtype where one pool is passed as K and V
    (``shared_pool``), ``"cuda_core"`` there with separate pools; else
    ``"tensor_core"`` at ``(dk, dv)`` in ``TENSOR_CORE_WIDTHS`` with at
    least ``TENSOR_CORE_MIN_ROWS`` folded queries (``ql = G*T``), or at
    widths the decode path does not take (192), bf16 or f32 (3xTF32);
    ``"decode"`` for at most 8 folded queries with ``dk, dv`` in {64, 128},
    f32 or bf16; ``"cuda_core"`` for every other call: odd widths and
    MLA's separate pools.  No f32 call stays on the CUDA cores where the
    tensor-core route measured faster: at every f32 fold from 9 rows it did
    (verify T 9, parity's 16-row chunk-extend, the zoo's folds; see
    ``TENSOR_CORE_MIN_ROWS``)."""
    if (dk, dv) == MLA_WIDTHS:
        return "tensor_core" if shared_pool else "cuda_core"
    decode_widths = dk in DECODE_WIDTHS and dv in DECODE_WIDTHS
    if (dk, dv) in TENSOR_CORE_WIDTHS and (ql >= TENSOR_CORE_MIN_ROWS or not decode_widths):
        return "tensor_core"
    if ql <= DECODE_MAX_ROWS and decode_widths:
        return "decode"
    return "cuda_core"


def tensor_core_plan(batch: int, hkv: int, ql: int, pages_per_slot: int, page_size: int,
                     sms: int, widths: tuple, dtype: torch.dtype = torch.bfloat16) -> tuple:
    """``(groups, splits)`` of a tensor-core call on a card of ``sms`` SMs
    at ``widths`` ``(dk, dv)``: the row groups the fold of ``ql`` rows is
    cut into (as few as keep a group at ``TENSOR_CORE_MAX_TILES`` M-tiles,
    ``TENSOR_CORE_F32_MAX_TILES[dk]`` in f32, ``MLA_MAX_TILES`` at
    ``MLA_WIDTHS``, ``MLA_F32_MAX_TILES`` there in f32, balanced, none
    empty), and how many blocks share a row's 32-key
    units (the grid's B x Hkv x groups blocks raised to
    ``TENSOR_CORE_BLOCKS_PER_SM`` an SM, ``MLA_FILL`` of the SMs at
    ``MLA_WIDTHS``, ``MLA_F32_FILL`` in f32, where each split keeps
    ``TENSOR_CORE_MIN_UNITS`` units of the page table's span, at most
    ``TENSOR_CORE_MAX_SPLITS``, ``MLA_MAX_SPLITS`` at ``MLA_WIDTHS``)."""
    mla = tuple(widths) == MLA_WIDTHS
    f32 = dtype == torch.float32
    if mla:
        max_tiles = MLA_F32_MAX_TILES if f32 else MLA_MAX_TILES
    else:
        max_tiles = TENSOR_CORE_F32_MAX_TILES[widths[0]] if f32 else TENSOR_CORE_MAX_TILES
    mtiles = -(-ql // 16)
    tiles = -(-mtiles // -(-mtiles // max_tiles))
    groups = -(-mtiles // tiles)
    units = -(-pages_per_slot * page_size // TENSOR_CORE_UNIT)
    if mla:
        fill = int((MLA_F32_FILL if f32 else MLA_FILL) * sms) // (batch * hkv * groups)
        max_splits = MLA_MAX_SPLITS
    else:
        fill = TENSOR_CORE_BLOCKS_PER_SM * sms // (batch * hkv * groups)
        max_splits = TENSOR_CORE_MAX_SPLITS
    return groups, max(1, min(fill, units // TENSOR_CORE_MIN_UNITS, max_splits))


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


# The split paths' f32 workspace and int32 counters, one pair per device,
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

    On the ``decode`` and ``tensor_core`` paths with more than one split,
    the splits' partial softmax states go to an f32 workspace and a
    per-(row, kv head) int32 counter (per row group on the tensor-core
    path) tells the last block of each to merge them; it resets the
    counter to 0.  At MLA's widths the splits merge in a thread-block
    cluster and take neither.  Workspace and counters are one pair per device, kept
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
    if _build.runs_plain(*tensors):
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
    # MLA's tensor-core kernel reads the values from the key pages
    shared_pool = v_pages.data_ptr() == k_pages.data_ptr() and dv_store == dk
    path = kernel_path(q.dtype, ql, dk, dv, shared_pool=shared_pool)
    mla = (dk, dv) == MLA_WIDTHS
    splits, round_pages, groups, ws_ptr, counters_ptr = 1, 1, 1, None, None
    P = page_table.shape[1]
    if path == "decode":
        splits, round_pages = decode_plan(b, hkv, P, page_size, dk, dv, q.element_size(),
                                          _sm_count(q.device.index))
    elif path == "tensor_core":
        groups, splits = tensor_core_plan(b, hkv, ql, P, page_size, _sm_count(q.device.index),
                                          (dk, dv), q.dtype)
    if splits > 1 and not (path == "tensor_core" and mla):
        ws, counters = _decode_buffers(q.device, b * hkv * splits * ql * (dv + 2),
                                       b * hkv * groups)
        ws_ptr, counters_ptr = ws.data_ptr(), counters.data_ptr()
    status = _build.library().paged_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        b, hkv, ql, dk, n_pages, page_size, P, dv_store, dv,
        tokens_per_row, float(scale), float(softcap), PATHS.index(path), splits, round_pages,
        groups, ws_ptr, counters_ptr, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, f"paged_attention_fwd ({path} path)")
    _build.count_launch(paged_flash_attention_folded, path)
    return out


paged_flash_attention_folded.launches = 0
paged_flash_attention_folded.launches_by_path = dict.fromkeys(PATHS, 0)
