"""The paged-attention kernel's three paths: which calls take the
tensor-core path and which the split-KV decode path
(``flash_decode.kernel_path``, MLA's fold by its pools in both dtypes),
how a decode call is split and streamed (``flash_decode.decode_plan``),
how a tensor-core call is cut into row groups and key splits and what its
blocks hold in shared memory in either dtype (``flash_decode.tensor_core_plan``,
and the C launchers' budgets), the f32 tensor-core routes' 3xTF32
arithmetic (MLA's fold and the GQA folds) emulated on the CPU, and the
plain version that ``chip_smoke.py`` holds those paths
to, against the reference package (its kernel in interpret mode and its
oracle) at the paths' shapes, on identical numpy inputs, at the f32
(2e-5) and bf16 (2e-2) tolerances."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_decode
from test_torch_flash import _mm_3xtf32, _tf32
from test_torch_kernels import _alloc_table, _paged_case, _run_both, f32, tol

torch.set_num_threads(1)  # the test workers share the host's cores


# The CUDA kernel's tensor-core path takes bf16 and f32 folds from
# TENSOR_CORE_MIN_ROWS rows at dk, dv in {64, 128}, and every fold at
# dk = dv = 192; these are its bf16 shapes (page sizes 8-32, offsets 0 and
# straddling a page, one and two query groups, a ragged 24-row fold, a
# softcap), held in the plain version that chip_smoke.py holds it to.
TC_CASES = [(g, 16, ps, dk, 0.0) for ps in (8, 16, 32) for dk in (64, 128) for g in (1, 2)]
TC_CASES += [(1, 16, 16, 64, 30.0), (3, 8, 16, 64, 0.0)]


@pytest.mark.parametrize("g,T,ps,dk,softcap", TC_CASES)
def test_paged_attention_tensor_core_shapes_vs_reference(g, T, ps, dk, softcap):
    hkv = 2
    case = _paged_case(B=2, T=T, hkv=hkv, g=g, dk=dk, ps=ps, P=96 // ps, n_pages=2 * 96 // ps + 2,
                       offsets=[0, ps // 2 + 3], seed=ps + dk + g)
    assert flash_decode.kernel_path(torch.bfloat16, g * T, dk, dk) == "tensor_core"
    got, want_kernel, want_ref, port_ref = _run_both(*case, dtype="bfloat16", softcap=softcap)
    assert got.shape == (2, T, hkv * g, dk)
    for want in (want_kernel, want_ref, port_ref):
        np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


# The dense zoo's folds on the tensor-core path at small sizes, both dtypes: dk 192
# (nemotron-4-340b's prefill and its 12-row decode fold), a 12-row fold at
# dk 64, MQA past 128 rows (G 48 x T 4 at Hkv 1: two row groups), and a
# parked row (every table entry the sentinel) beside rows whose first
# pages alias one physical page.
TC_FOLDS = [(2, 1, 16, 16, 192, False), (2, 12, 1, 16, 192, False), (2, 12, 1, 16, 64, False),
            (1, 48, 4, 16, 128, False), (1, 48, 4, 8, 128, True), (2, 9, 1, 16, 128, True)]


def _tc_fold(hkv, g, T, ps, dk, parked_aliased, dtype):
    q, k, v, table, offs = _paged_case(B=3, T=T, hkv=hkv, g=g, dk=dk, ps=ps, P=64 // ps,
                                       n_pages=3 * 64 // ps + 2, offsets=[0, ps + 3, 40],
                                       seed=ps + dk + g)
    if parked_aliased:
        table[1] = k.shape[0]  # parked: nothing attendable, zeros out
        table[2, 0] = table[0, 0]  # aliased first pages
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    assert flash_decode.kernel_path(tdtype, g * T, dk, dk) == "tensor_core"
    got, want_kernel, want_ref, port_ref = _run_both(q, k, v, table, offs, dtype=dtype)
    assert got.shape == (3, T, hkv * g, dk)
    if parked_aliased:
        assert bool((got[1] == 0).all())
    for want in (want_kernel, want_ref, port_ref):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("hkv,g,T,ps,dk,parked_aliased", TC_FOLDS)
def test_paged_attention_tensor_core_folds_vs_reference(hkv, g, T, ps, dk, parked_aliased):
    _tc_fold(hkv, g, T, ps, dk, parked_aliased, "bfloat16")


@pytest.mark.parametrize("hkv,g,T,ps,dk,parked_aliased", TC_FOLDS)
def test_paged_attention_tensor_core_folds_f32_vs_reference(hkv, g, T, ps, dk, parked_aliased):
    """The same folds in f32, which the tensor-core path takes in 3xTF32
    (its arithmetic: test_mla_f32_3xtf32_arithmetic_meets_the_gate)."""
    _tc_fold(hkv, g, T, ps, dk, parked_aliased, "float32")


@pytest.mark.parametrize("dtype,ql,dk,dv,path", [
    (torch.bfloat16, 16, 64, 64, "tensor_core"),     # serve prefill, G 1 x T 16
    (torch.bfloat16, 32, 64, 64, "tensor_core"),     # G 2 x T 16
    (torch.bfloat16, 24, 64, 64, "tensor_core"),     # ragged fold, G 3 x T 8
    (torch.bfloat16, 40, 128, 128, "tensor_core"),   # verify T 5 at G 8
    (torch.bfloat16, 16, 128, 64, "tensor_core"),
    (torch.bfloat16, 128, 64, 64, "tensor_core"),    # 8 M-tiles, the most a block takes
    (torch.bfloat16, 128, 64, 128, "tensor_core"),
    (torch.bfloat16, 96, 128, 128, "tensor_core"),   # 6 M-tiles
    (torch.bfloat16, 97, 128, 128, "tensor_core"),   # the shared stage fits 8 at 128
    (torch.bfloat16, 128, 128, 128, "tensor_core"),  # qwen2-72b's prefill, G 8 x T 16
    (torch.bfloat16, 1, 64, 64, "decode"),           # decode
    (torch.bfloat16, 8, 128, 128, "decode"),         # GQA decode, G 8
    (torch.bfloat16, 1, 128, 128, "decode"),
    (torch.bfloat16, 8, 64, 64, "decode"),
    (torch.bfloat16, 1, 64, 128, "decode"),
    (torch.float32, 1, 64, 64, "decode"),            # f32 parity decode
    (torch.float32, 8, 128, 128, "decode"),
    (torch.float32, 1, 128, 128, "decode"),
    (torch.float32, 8, 64, 64, "decode"),
    (torch.float32, 5, 128, 64, "decode"),           # verify T 5 at G 1
    (torch.bfloat16, 9, 64, 64, "tensor_core"),      # verify spec_k 8, the reference bench's
    (torch.bfloat16, 1, 576, 512, "tensor_core"),    # MLA decode at G 1
    (torch.float32, 1, 576, 512, "tensor_core"),     # one latent pool: 3xTF32
    (torch.bfloat16, 1, 32, 32, "cuda_core"),
    (torch.float32, 16, 128, 128, "tensor_core"),    # f32 chunk-extend: 3xTF32
    (torch.bfloat16, 15, 64, 64, "tensor_core"),
    (torch.bfloat16, 136, 64, 64, "tensor_core"),    # two row groups
    (torch.bfloat16, 16, 576, 512, "tensor_core"),   # MLA, G 16: one partial row group
    (torch.bfloat16, 16, 32, 32, "cuda_core"),
    (torch.bfloat16, 16, 64, 48, "cuda_core"),
    (torch.float32, 16, 64, 64, "tensor_core"),      # f32 parity's chunk-extend
    (torch.float32, 40, 128, 128, "tensor_core"),
    # ds-paper-100m's verify (G 1, T = spec_k + 1) and its draft's catch-up
    (torch.bfloat16, 5, 64, 64, "decode"),           # spec_k 4
    (torch.float32, 5, 64, 64, "decode"),
    (torch.bfloat16, 8, 64, 64, "decode"),           # spec_k 7, the decode path's last
    (torch.float32, 9, 64, 64, "tensor_core"),       # spec_k 8; its bf16 row is listed earlier
    (torch.bfloat16, 32, 64, 64, "tensor_core"),     # the draft's catch-up chunk
    (torch.float32, 32, 64, 64, "tensor_core"),
    # the dense zoo: nemotron-4-340b at dk 192 (decode G 12, prefill G 12 x
    # T 16, a 768-row fold), granite-34b's MQA (G 48 at T 1 and T 16),
    # qwen2-72b's G 8 decode and G 8 x T 16 prefill, in both dtypes (f32 on
    # the tensor cores in 3xTF32)
    (torch.bfloat16, 12, 192, 192, "tensor_core"),
    (torch.bfloat16, 128, 192, 192, "tensor_core"),
    (torch.bfloat16, 192, 192, 192, "tensor_core"),
    (torch.bfloat16, 768, 192, 192, "tensor_core"),
    (torch.bfloat16, 1, 192, 192, "tensor_core"),
    (torch.bfloat16, 48, 128, 128, "tensor_core"),
    (torch.bfloat16, 768, 128, 128, "tensor_core"),
    (torch.float32, 12, 192, 192, "tensor_core"),
    (torch.float32, 192, 192, 192, "tensor_core"),
    (torch.float32, 1, 192, 192, "tensor_core"),
    (torch.float32, 48, 128, 128, "tensor_core"),
    (torch.float32, 768, 128, 128, "tensor_core"),
    (torch.float32, 128, 128, 128, "tensor_core"),
    (torch.float32, 8, 128, 128, "decode"),          # qwen2's f32 decode stays on the decode path
    (torch.float32, 12, 192, 128, "cuda_core"),      # mixed 192 widths: not instantiated
    (torch.float32, 15, 64, 128, "tensor_core"),     # the mixed widths from 9 rows
    (torch.float32, 9, 128, 64, "tensor_core"),
    (torch.bfloat16, 12, 192, 128, "cuda_core"),     # mixed 192 widths: not instantiated
    # deepseek-v2-236b's MLA at full width: Hkv 1, G 128, the 576-wide latent
    # page with values from its first 512 columns; decode (128 rows) and a
    # T 4 chunk-extend (512 rows): one pool as K and V on the tensor cores
    # (csrc/paged_mla.cu) at every fold, bf16 and f32 (mla_parity, 3xTF32)
    (torch.bfloat16, 128, 576, 512, "tensor_core"),
    (torch.float32, 128, 576, 512, "tensor_core"),
    (torch.bfloat16, 512, 576, 512, "tensor_core"),
    (torch.float32, 512, 576, 512, "tensor_core"),
    (torch.bfloat16, 4, 576, 512, "tensor_core"),     # G 1 x T 4: under the decode path's 8
    (torch.bfloat16, 8, 576, 512, "tensor_core"),
    (torch.bfloat16, 64, 576, 512, "tensor_core"),    # one full 64-row group
    (torch.bfloat16, 65, 576, 512, "tensor_core"),    # a second group of one row
    (torch.float32, 16, 576, 512, "tensor_core"),
    (torch.float32, 4, 576, 512, "tensor_core"),
])
def test_paged_kernel_path_table(dtype, ql, dk, dv, path):
    assert flash_decode.kernel_path(dtype, ql, dk, dv) == path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ql", [1, 4, 16, 128, 512])
def test_paged_kernel_path_mla_pools(dtype, ql):
    """At MLA's widths ``kernel_path`` alone decides on the pools: one
    latent pool passed as K and V takes the tensor-core kernel (which reads
    the values from the key pages) in both dtypes, separate K and V pools
    the CUDA-core kernel; the default is one pool."""
    assert flash_decode.kernel_path(dtype, ql, 576, 512, shared_pool=True) == "tensor_core"
    assert flash_decode.kernel_path(dtype, ql, 576, 512) == "tensor_core"
    assert flash_decode.kernel_path(dtype, ql, 576, 512, shared_pool=False) == "cuda_core"
    # the pools do not move a call at any other width
    for dk in (64, 128, 192):
        assert (flash_decode.kernel_path(dtype, ql, dk, dk, shared_pool=False)
                == flash_decode.kernel_path(dtype, ql, dk, dk))


def tensor_core_block(tiles, dk, dv, splits=1, itemsize=2):
    """``(wsplits, stages, smem_bytes)`` of a tensor-core block of ``tiles``
    M-tiles under ``splits`` key splits, as ``csrc/paged_tensor_core.cu``'s
    ``tc_block`` lays it out for elements of ``itemsize`` bytes: below 4
    M-tiles 4 / tiles in-block key splits, halved while two stages of them
    pass the 200 KiB ring budget; in f32 the group's Q rows (padded by 4
    floats) before the ring; 3 stages of one 32-key K and V unit a split
    (rows padded by 16 bytes), 2 where 3 pass the ring budget with splits in
    the block, or Q and the ring pass 226 KiB; the ring, or the warps'
    merge slots or the split merge's weights where larger."""
    def ring(stages, wsplits):
        return stages * wsplits * 32 * ((dk + dv) * itemsize + 32)

    q = tiles * 16 * (dk * 4 + 16) if itemsize == 4 else 0  # bf16 keeps Q in registers
    wsplits = 1 if tiles >= 4 else 4 // tiles
    while wsplits > 1 and ring(2, wsplits) > 200 * 1024:
        wsplits //= 2
    three = ring(3, wsplits)
    stages = 2 if (wsplits > 1 and three > 200 * 1024) or q + three > 226 * 1024 else 3
    merge = tiles * wsplits * (32 + 16 * dv) * 4 if wsplits > 1 else 0
    weights = (splits + 1) * tiles * 16 * 4 if splits > 1 else 0
    return wsplits, stages, max(q + ring(stages, wsplits), merge, weights)


def test_tensor_core_calls_fit_the_blocks_shared_memory():
    """Every call routed to the tensor-core path, bf16 and f32, fits the C
    launcher's budget (``run_tc``/``tc_block``: a row group of at most 8
    M-tiles, a warp each, times the in-block key splits, at most 8 warps; a
    ring of 3 stages, or 2 where 3 pass 200 KiB with splits in the block or
    f32's Q and the ring pass 226 KiB, of one 32-key K and V unit a split
    with rows padded by 16 bytes, shared by every warp, or the warps' merge
    slots or the split merge's weights, within the H100's 227 KiB a
    block).  The private per-warp rings before it failed to launch
    qwen2-72b's bf16 prefill (G*T 128 at dk = dv = 128: 272 KiB)."""
    for dtype, itemsize in ((torch.bfloat16, 2), (torch.float32, 4)):
        for dk, dv in flash_decode.TENSOR_CORE_WIDTHS:
            if (dk, dv) == flash_decode.MLA_WIDTHS:
                continue  # its own block: test_mla_calls_fit_the_blocks_shared_memory
            for ql in range(1, 8 * 16 * 3 + 1):
                if flash_decode.kernel_path(dtype, ql, dk, dv) != "tensor_core":
                    assert ql < flash_decode.TENSOR_CORE_MIN_ROWS and dk != 192, (dtype, ql, dk)
                    continue
                for batch, hkv in ((16, 1), (1, 1), (16, 8)):
                    groups, splits = flash_decode.tensor_core_plan(
                        batch, hkv, ql, 256, 16, sms=132, widths=(dk, dv), dtype=dtype)
                    mtiles = -(-ql // 16)
                    tiles = -(-mtiles // groups)  # as run_tc derives it
                    cap = (flash_decode.TENSOR_CORE_F32_MAX_TILES[dk] if itemsize == 4
                           else flash_decode.TENSOR_CORE_MAX_TILES)
                    assert tiles <= cap <= 8 and (groups - 1) * tiles < mtiles, (ql, groups)
                    wsplits, stages, smem = tensor_core_block(tiles, dk, dv, splits, itemsize)
                    assert smem <= 227 * 1024 and tiles * wsplits <= 8, (dtype, ql, dk, dv)
    # 8 M-tiles at every width read one shared stage: 51 KiB at 128, 75 KiB at 192
    assert tensor_core_block(8, 128, 128) == (1, 3, 52224)
    assert tensor_core_block(8, 192, 192) == (1, 3, 76800)
    # one M-tile: 4 in-block splits, 3 stages at 64 and 2 at 128 and 192
    # (a ring of at most 200 KiB)
    assert tensor_core_block(1, 64, 64) == (4, 3, 110592)
    assert tensor_core_block(1, 128, 128) == (4, 2, 139264)
    assert tensor_core_block(1, 192, 192) == (4, 2, 204800)
    # the split merge's weights: (splits + 1) x the group's rows, f32
    assert tensor_core_block(8, 64, 64, splits=132)[2] == 133 * 128 * 4
    # f32: Q (rows of dk + 4 floats) beside the ring.  nemotron's prefill
    # group of 4 M-tiles at 192 (its plan's cap): Q 49 KiB and 3 stages of
    # 49 KiB; 6 fit 3 stages too (Q 73.5 KiB); granite's 8 at 128: Q 66 KiB
    # and 3 stages of 33 KiB; 8 M-tiles at 192 take 2 stages (Q 98 KiB)
    assert tensor_core_block(4, 192, 192, itemsize=4) == (1, 3, 64 * 784 + 3 * 32 * 1568)
    assert tensor_core_block(6, 192, 192, itemsize=4) == (1, 3, 96 * 784 + 3 * 32 * 1568)
    assert tensor_core_block(6, 192, 192, itemsize=4)[2] == 225792 <= 226 * 1024
    assert tensor_core_block(8, 128, 128, itemsize=4) == (1, 3, 128 * 528 + 3 * 32 * 1056)
    assert tensor_core_block(8, 192, 192, itemsize=4) == (1, 2, 128 * 784 + 2 * 32 * 1568)
    # nemotron's 12-row decode: 2 in-block splits of 2 stages; granite's 48
    # rows: 3 M-tiles, 3 stages; a 9-16-row fold at 64: 4 splits, 2 stages
    assert tensor_core_block(1, 192, 192, itemsize=4) == (2, 2, 16 * 784 + 4 * 32 * 1568)
    assert tensor_core_block(3, 128, 128, itemsize=4) == (1, 3, 48 * 528 + 3 * 32 * 1056)
    assert tensor_core_block(1, 64, 64, itemsize=4) == (4, 2, 16 * 272 + 8 * 32 * 544)


# csrc/paged_mla.cu's MlaCfg: (padded row in elements, element bytes, unit
# keys, M-tiles a block, warps an M-tile) of each route
MLA_CFG = {torch.bfloat16: (576 + 8, 2, 32, 4, 4), torch.float32: (576 + 4, 4, 16, 2, 4)}


def mla_block(tiles, splits=1, dtype=torch.bfloat16):
    """``(stages, smem_bytes)`` of an MLA block of ``tiles`` M-tiles under
    ``splits`` key splits, as ``csrc/paged_mla.cu``'s ``mla_block`` lays it
    out: the group's Q rows (576 bf16 padded to 584, or 576 f32 padded to
    580), 3 stages of one latent unit (32 keys in bf16, 16 in f32; 2 stages
    where 3 pass the 226 KiB budget), the partial S of the 4 warps of each
    M-tile and the M-tile's summed S (16 x unit f32 each); with key splits,
    where larger, the merge over them: the block's state (each row's f32 o,
    padded to 520 floats, and (m, l)) and the weights of the rows it
    merges."""
    ld, item, unit, _, nw = MLA_CFG[dtype]

    def total(stages):
        return (tiles * 16 * ld * item + stages * unit * ld * item
                + tiles * (nw + 1) * 16 * unit * 4)

    stages = 3 if total(3) <= 226 * 1024 else 2
    merge = tiles * 16 * (520 * 4 + 8) + (splits + 1) * tiles * 16 * 4 if splits > 1 else 0
    return stages, max(total(stages), merge)


def test_mla_calls_fit_the_blocks_shared_memory():
    """Every fold at MLA's widths with one latent pool takes the tensor-core
    path in both dtypes, and its block fits the C launcher's budget
    (``run_mla``/``mla_block``: a row group of at most 4 M-tiles in bf16, 2
    in f32, of 4 warps each, at most 512 threads; Q, a 3-stage latent ring
    and the partial-S slots within 226 KiB of the H100's 227 KiB a block)
    under every key split the plan gives: G*T 1-200, MLA's decode at G 16
    and G 128 and the T 4 fold of 512 rows, rows of 1-16 batch rows over
    page tables of 2-256 pages."""
    for dtype in (torch.bfloat16, torch.float32):
        max_tiles = MLA_CFG[dtype][3]
        seen_splits = set()
        for ql in [*range(1, 201), 256, 512]:
            assert flash_decode.kernel_path(dtype, ql, 576, 512) == "tensor_core", ql
            for batch in (1, 2, 16):
                for P, ps in ((2, 16), (40, 16), (80, 8), (10, 64), (256, 16)):
                    groups, splits = flash_decode.tensor_core_plan(
                        batch, 1, ql, P, ps, sms=132, widths=(576, 512), dtype=dtype)
                    mtiles = -(-ql // 16)
                    tiles = -(-mtiles // groups)  # as run_mla derives it
                    assert tiles <= max_tiles and (groups - 1) * tiles < mtiles, (dtype, ql)
                    assert 1 <= splits <= max(1, -(-P * ps // 32)), (ql, batch, P)
                    seen_splits.add(splits)
                    for any_splits in range(1, flash_decode.MLA_MAX_SPLITS + 1):
                        smem = mla_block(tiles, any_splits, dtype)[1]
                        assert smem <= 226 * 1024 and tiles * 4 * 32 <= 512, (
                            dtype, ql, tiles, any_splits)
        assert min(seen_splits) == 1 and max(seen_splits) == flash_decode.MLA_MAX_SPLITS == 8
    assert flash_decode.MLA_F32_MAX_TILES == MLA_CFG[torch.float32][3]
    assert flash_decode.MLA_MAX_TILES == MLA_CFG[torch.bfloat16][3]
    # a 64-row group: Q 73 KiB, 3 stages of 36.5 KiB, 40 KiB of partial
    # and summed S
    assert mla_block(4) == (3, 4 * 16 * 584 * 2 + 3 * 32 * 584 * 2 + 4 * 5 * 2048) == (3, 227840)
    assert mla_block(1) == (3, 141056)
    # the split merge (the block's state, 130.5 KiB at 64 rows, and the
    # weights) fits beneath Q and the ring at the most splits
    assert mla_block(4, splits=8) == (3, 227840)
    assert 4 * 16 * (520 * 4 + 8) + 9 * 64 * 4 < 4 * 16 * 584 * 2 + 3 * 32 * 584 * 2
    # f32: a 32-row group's Q 72.5 KiB, 3 stages of 16 keys at 36.25 KiB,
    # 10 KiB of partial and summed S; a 64-row group's Q (145 KiB) leaves no
    # room for a ring of two 16-key units, and 32-key units fit two stages
    # only beside one M-tile's Q
    f32 = torch.float32
    assert mla_block(2, dtype=f32) == (3, 2 * 16 * 580 * 4 + 3 * 16 * 580 * 4 + 2 * 5 * 1024)
    assert mla_block(2, dtype=f32) == (3, 195840) and mla_block(1, dtype=f32) == (3, 153600)
    assert mla_block(2, splits=8, dtype=f32) == (3, 195840)
    assert 4 * 16 * 580 * 4 + 2 * 16 * 580 * 4 + 4 * 5 * 1024 > 226 * 1024
    assert 2 * 16 * 580 * 4 + 2 * 32 * 580 * 4 + 2 * 5 * 2048 > 226 * 1024
    assert 16 * 580 * 4 + 2 * 32 * 580 * 4 + 5 * 2048 <= 226 * 1024


@pytest.mark.parametrize("batch,hkv,ql,P,ps,want", [
    (16, 12, 16, 40, 16, (1, 1)),     # ds-paper-100m's serve prefill: 192 blocks, no split
    (16, 1, 48, 40, 16, (1, 8)),      # granite-34b's MQA decode: 16 blocks -> 8 splits
    (16, 1, 768, 40, 16, (6, 1)),     # granite's prefill: 48 M-tiles in 6 groups of 8
    (16, 8, 128, 40, 16, (1, 1)),     # qwen2-72b's prefill: 8 M-tiles, 128 blocks
    (16, 8, 12, 40, 16, (1, 1)),      # nemotron-4-340b's decode fold
    (16, 8, 192, 40, 16, (2, 1)),     # nemotron's prefill: 12 M-tiles in 2 groups of 6
    (1, 1, 48, 256, 16, (1, 16)),     # MQA G 48 over one row of 4096 keys: the most splits
    (2, 1, 48, 2, 16, (1, 1)),        # a row of one unit keeps one split
    (16, 12, 9, 40, 16, (1, 1)),      # verify T 9 at G 1
    (1, 1, 144, 8, 64, (2, 8)),       # 9 M-tiles: 2 groups (of 5 and 4); 16 units
    (2, 8, 144, 40, 16, (2, 4)),      # 32 blocks of 9 M-tiles in 2 groups -> 4 splits
])
def test_tc_plan(batch, hkv, ql, P, ps, want):
    # one plan at every tensor-core width but MLA's
    for widths in flash_decode.TENSOR_CORE_WIDTHS:
        if widths != flash_decode.MLA_WIDTHS:
            plan = flash_decode.tensor_core_plan(batch, hkv, ql, P, ps, sms=132, widths=widths)
            assert plan == want, widths
    groups, splits = want
    mtiles = -(-ql // 16)
    tiles = -(-mtiles // groups)
    assert tiles <= flash_decode.TENSOR_CORE_MAX_TILES and (groups - 1) * tiles < mtiles
    units = -(-P * ps // 32)
    assert 1 <= splits <= max(1, units)
    if splits > 1:
        assert batch * hkv * groups * splits <= 132 and units // splits >= 2 and splits <= 16


@pytest.mark.parametrize("batch,hkv,ql,P,ps,widths,want", [
    (16, 8, 192, 40, 16, (192, 192), (3, 1)),  # nemotron's f32 prefill: 3 groups of 4 M-tiles
    (16, 8, 12, 40, 16, (192, 192), (1, 1)),   # its decode fold: 128 blocks
    (16, 1, 768, 40, 16, (128, 128), (6, 1)),  # granite's f32 prefill: 6 groups of 8
    (16, 1, 48, 40, 16, (128, 128), (1, 8)),   # granite's MQA decode: 16 blocks -> 8 splits
    (16, 8, 128, 40, 16, (128, 128), (1, 1)),  # qwen2's f32 prefill: one group of 8
    (4, 12, 16, 8, 16, (64, 64), (1, 2)),      # parity's f32 chunk-extend: 48 blocks, 8 units
    (1, 1, 48, 256, 16, (128, 128), (1, 16)),  # one MQA row of 4096 keys: the most splits
    (2, 8, 144, 40, 16, (192, 192), (3, 2)),   # 9 M-tiles at 192: groups of 3
])
def test_tc_plan_f32(batch, hkv, ql, P, ps, widths, want):
    """The f32 plan at the GQA widths: row groups of at most
    ``TENSOR_CORE_F32_MAX_TILES[dk]`` M-tiles (4 at 192, 8 below), the key
    splits of the bf16 plan; bf16 keeps groups of up to 8."""
    plan = flash_decode.tensor_core_plan(batch, hkv, ql, P, ps, sms=132, widths=widths,
                                         dtype=torch.float32)
    assert plan == want
    groups, splits = plan
    mtiles = -(-ql // 16)
    tiles = -(-mtiles // groups)
    assert tiles <= flash_decode.TENSOR_CORE_F32_MAX_TILES[widths[0]]
    assert (groups - 1) * tiles < mtiles
    if splits > 1:
        assert batch * hkv * groups * splits <= 132 and splits <= 16
    bf16 = flash_decode.tensor_core_plan(batch, hkv, ql, P, ps, sms=132, widths=widths)
    assert bf16[0] == -(-mtiles // 8)


@pytest.mark.parametrize("batch,hkv,ql,P,ps,want", [
    (16, 1, 128, 40, 16, (2, 3)),     # deepseek-v2-236b's decode: 32 blocks -> 3 splits
    (16, 1, 512, 40, 16, (8, 1)),     # its T 4 fold: 8 groups of 64 rows, 128 blocks
    (2, 1, 16, 40, 16, (1, 8)),       # G 16 over 2 rows: one partial group, 8 splits
    (1, 1, 128, 256, 16, (2, 8)),     # one row of 4096 keys: the most splits, a cluster's 8
    (16, 1, 128, 2, 16, (2, 1)),      # a row of one unit keeps one split
])
def test_tc_plan_mla(batch, hkv, ql, P, ps, want):
    """The plan at MLA's widths: row groups of at most ``MLA_MAX_TILES``
    M-tiles (64 rows), then key splits filling ``MLA_FILL`` of the SMs, at
    most a cluster's ``MLA_MAX_SPLITS``."""
    groups, splits = flash_decode.tensor_core_plan(batch, hkv, ql, P, ps, sms=132,
                                                   widths=flash_decode.MLA_WIDTHS)
    assert (groups, splits) == want
    mtiles = -(-ql // 16)
    tiles = -(-mtiles // groups)
    assert tiles <= flash_decode.MLA_MAX_TILES and (groups - 1) * tiles < mtiles
    if splits > 1:  # the split grid fits the clusters the card holds at once (99 of 132)
        assert batch * hkv * groups * splits <= 99 and splits <= flash_decode.MLA_MAX_SPLITS
    # the same fold at other widths keeps groups of up to 8 M-tiles
    assert flash_decode.tensor_core_plan(batch, hkv, ql, P, ps, sms=132,
                                         widths=(192, 192))[0] == -(-mtiles // 8)


@pytest.mark.parametrize("batch,hkv,ql,P,ps,want", [
    (16, 1, 128, 40, 16, (4, 3)),     # deepseek-v2-236b's f32 decode: 64 blocks -> 3 splits
    (16, 1, 512, 40, 16, (16, 1)),    # its T 4 fold: 16 groups of 32 rows, 256 blocks
    (2, 1, 16, 40, 16, (1, 8)),       # G 16 over 2 rows: one partial group, 8 splits
    (1, 1, 128, 256, 16, (4, 8)),     # one row of 4096 keys: the most splits, a cluster's 8
    (16, 1, 128, 2, 16, (4, 1)),      # a row of one unit keeps one split
])
def test_tc_plan_mla_f32(batch, hkv, ql, P, ps, want):
    """The plan of the f32 MLA fold (3xTF32): row groups of at most
    ``MLA_F32_MAX_TILES`` M-tiles (32 rows), then key splits filling
    ``MLA_F32_FILL`` of the SMs, at most a cluster's ``MLA_MAX_SPLITS``;
    bf16 keeps its own plan."""
    groups, splits = flash_decode.tensor_core_plan(batch, hkv, ql, P, ps, sms=132,
                                                   widths=flash_decode.MLA_WIDTHS,
                                                   dtype=torch.float32)
    assert (groups, splits) == want
    mtiles = -(-ql // 16)
    tiles = -(-mtiles // groups)
    assert tiles <= flash_decode.MLA_F32_MAX_TILES and (groups - 1) * tiles < mtiles
    if splits > 1:  # the split grid fills at most MLA_F32_FILL of the SMs
        assert batch * hkv * groups * splits <= flash_decode.MLA_F32_FILL * 132
        assert splits <= flash_decode.MLA_MAX_SPLITS
    assert flash_decode.tensor_core_plan(batch, hkv, ql, P, ps, sms=132,
                                         widths=flash_decode.MLA_WIDTHS)[0] == -(-mtiles // 4)


def _f32_route(q, k_pool, v_pool, table, offs, scale, v_width=0, tf32_only=False):
    """The f32 tensor-core routes' arithmetic on the CPU (csrc/paged_mla.cu
    at MLA's fold, csrc/paged_tensor_core.cu at the GQA folds): each row's
    K and V gathered through its page table, S = Q.K^T and P.V (values the
    first ``v_width`` columns) in 3xTF32 for each KV head's G query heads
    (plain TF32 with ``tf32_only``), S scaled in fp32, P unnormalised and
    divided by the fp32 row sum after; a row with nothing to attend gives
    zeros."""
    mm = (lambda a, b: _tf32(a) @ _tf32(b)) if tf32_only else _mm_3xtf32
    n_pages, ps, hkv, dk = k_pool.shape
    B, T, H, _ = q.shape
    g, dv = H // hkv, v_width or v_pool.shape[-1]
    out = torch.zeros((B, T, H, dv))
    for b in range(B):
        safe = table[b].clamp(max=n_pages - 1)
        k = k_pool[safe].reshape(-1, hkv, dk)
        v = v_pool[safe].reshape(-1, hkv, v_pool.shape[-1])[..., :dv]
        alloc = (table[b] < n_pages).repeat_interleave(ps)
        qpos = offs[b] + torch.arange(T)
        mask = (torch.arange(k.shape[0])[None] <= qpos[:, None]) & alloc[None]  # (T, keys)
        for h in range(hkv):
            heads = slice(h * g, (h + 1) * g)
            s = mm(q[b, :, heads].reshape(T * g, dk), k[:, h].T).reshape(T, g, -1) * scale
            s = s.masked_fill(~mask[:, None], -math.inf)
            m = s.amax(-1, keepdim=True).clamp(min=-1e30)
            p = torch.exp(s - m)
            out[b, :, heads] = mm(p.reshape(T * g, -1), v[:, h]).reshape(T, g, dv) / p.sum(
                -1, keepdim=True).clamp(min=1e-30)
    return out


# fold -> (Hkv, dk, dv, v_width, scale): MLA's one 576-wide pool as K and V
# (values its first 512 columns, scale 1 / sqrt(192)); the GQA folds' own
# K and V pools at the zoo's widths
F32_FOLDS = {"mla": (1, 576, 576, 512, 1.0 / math.sqrt(192)),
             "gqa64": (2, 64, 64, 0, 1.0 / math.sqrt(64)),
             "gqa128": (1, 128, 128, 0, 1.0 / math.sqrt(128)),
             "gqa192": (2, 192, 192, 0, 1.0 / math.sqrt(192))}


@pytest.mark.parametrize("T,g,ps,parked,fold", [
    pytest.param(1, 16, 16, False, "mla", id="1-16-16-False"),
    pytest.param(4, 8, 8, False, "mla", id="4-8-8-False"),
    pytest.param(1, 32, 16, True, "mla", id="1-32-16-True"),
    # granite-34b's MQA (G 48) decode with a parked row and its T 16 fold;
    # nemotron-4-340b's G 12 at dk 192; a T 16 chunk-extend at dk 64
    pytest.param(1, 48, 16, True, "gqa128", id="gqa-dk128-g48-decode-parked"),
    pytest.param(16, 48, 16, False, "gqa128", id="gqa-dk128-g48-t16"),
    pytest.param(1, 12, 8, False, "gqa192", id="gqa-dk192-g12-page8"),
    pytest.param(16, 1, 16, False, "gqa64", id="gqa-dk64-t16"),
])
def test_mla_f32_3xtf32_arithmetic_meets_the_gate(T, g, ps, parked, fold):
    """The f32 tensor-core routes' 3xTF32 arithmetic (csrc/paged_mla.cu at
    MLA's widths: one 576-wide pool as K and V, values its first 512
    columns, scale 1 / sqrt(192); csrc/paged_tensor_core.cu at the GQA
    folds), emulated on the CPU with TF32 rounding by integer bit
    arithmetic, holds the reference package's paged oracle at the f32 gate
    (2e-5), a parked row giving zeros; plain TF32 misses it."""
    hkv, dk, dv, v_width, scale = F32_FOLDS[fold]
    B, P = 3, 160 // ps
    rng = np.random.default_rng(T + g + ps + (0 if fold == "mla" else dk))
    k = rng.standard_normal((B * P + 2, ps, hkv, dk)).astype(np.float32)
    v = k if fold == "mla" else rng.standard_normal((B * P + 2, ps, hkv, dv)).astype(np.float32)
    q = rng.standard_normal((B, T, hkv * g, dk)).astype(np.float32)
    offs = np.asarray([150 - T, 37, 90], np.int32)
    table = _alloc_table(B, P, k.shape[0], offs + T, ps)
    if parked:
        table[1] = k.shape[0]
    want = f32(jref.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(offs), scale=scale, v_width=v_width))
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    tt, to = torch.from_numpy(table).long(), torch.from_numpy(offs).long()
    got = _f32_route(tq, tk, tv, tt, to, scale, v_width)
    np.testing.assert_allclose(f32(got), want, rtol=2e-5, atol=2e-5)
    if parked:
        assert bool((got[1] == 0).all())
    rough = _f32_route(tq, tk, tv, tt, to, scale, v_width, tf32_only=True)
    assert not np.allclose(f32(rough), want, rtol=2e-5, atol=2e-5)


# The decode path's shapes (G*T <= 8, dk and dv in {64, 128}, f32 and
# bf16): decode at G 1 and GQA G 8, a verify fold of G 1 x T 5, pages of 8
# to 64 keys, a context of 1 key (offset 0), a softcap.
DECODE_CASES = [(1, 1, ps, dk, 0.0) for ps in (8, 16, 64) for dk in (64, 128)]
DECODE_CASES += [(8, 1, 16, 128, 0.0), (4, 2, 16, 64, 0.0), (1, 5, 16, 64, 0.0),
                 (1, 1, 16, 64, 30.0), (1, 5, 8, 64, 0.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,T,ps,dk,softcap", DECODE_CASES)
def test_paged_attention_decode_shapes_vs_reference(g, T, ps, dk, softcap, dtype):
    hkv = 2
    case = _paged_case(B=3, T=T, hkv=hkv, g=g, dk=dk, ps=ps, P=128 // ps,
                       n_pages=3 * 128 // ps + 2, offsets=[0, ps + 3, 128 - T], seed=ps + dk + g)
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    assert flash_decode.kernel_path(tdtype, g * T, dk, dk) == "decode"
    got, want_kernel, want_ref, port_ref = _run_both(*case, dtype=dtype, softcap=softcap)
    assert got.shape == (3, T, hkv * g, dk)
    for want in (want_kernel, want_ref, port_ref):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("batch,hkv,P,ps,dk,itemsize,want", [
    (16, 12, 40, 16, 64, 2, (2, 7)),    # serve decode: ~2 blocks an SM on 132 SMs
    (16, 12, 256, 16, 64, 2, (5, 7)),   # 4096 keys: at most 8 rounds of 7 pages a split
    (1, 12, 8, 16, 64, 2, (2, 4)),      # one row: at least 4 pages a split
    (1, 12, 2, 16, 64, 2, (1, 2)),
    (4, 12, 8, 16, 64, 4, (2, 3)),      # the f32 parity engine's slots
    (3, 8, 40, 16, 128, 2, (10, 3)),    # GQA G 8 at dk 128
    (1, 12, 256, 16, 64, 2, (22, 7)),   # one row over 4096 keys: ~2 blocks an SM
    (16, 12, 1, 64, 128, 4, (1, 1)),    # a page larger than a round's budget
])
def test_decode_plan(batch, hkv, P, ps, dk, itemsize, want):
    splits, round_pages = flash_decode.decode_plan(batch, hkv, P, ps, dk, dk, itemsize, sms=132)
    assert (splits, round_pages) == want
    assert 1 <= splits <= max(1, P) and 1 <= round_pages <= -(-P // splits)
    page_bytes = ps * (2 * dk * itemsize + 32)
    assert round_pages * page_bytes <= max(flash_decode.DECODE_ROUND_BYTES, page_bytes)
