"""The paged-attention kernel's three paths: which calls take the bf16
tensor-core path and which the split-KV decode path
(``flash_decode.kernel_path``), how a decode call is split and streamed
(``flash_decode.decode_plan``), and the plain version that
``chip_smoke.py`` holds those paths to, against the reference package
(its kernel in interpret mode and its oracle) at the paths' shapes, on
identical numpy inputs, at the f32 (2e-5) and bf16 (2e-2) tolerances."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode
from test_torch_kernels import _paged_case, _run_both, f32, tol

torch.set_num_threads(1)  # the test workers share the host's cores


# The CUDA kernel's tensor-core path takes bf16 chunk-extend with G*T >= 16
# and dk, dv in {64, 128}; these are its shapes (page sizes 8-32, offsets 0
# and straddling a page, one and two query groups, a ragged 24-row fold,
# a softcap), held in the plain version that chip_smoke.py holds it to.
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


@pytest.mark.parametrize("dtype,ql,dk,dv,path", [
    (torch.bfloat16, 16, 64, 64, "tensor_core"),     # serve prefill, G 1 x T 16
    (torch.bfloat16, 32, 64, 64, "tensor_core"),     # G 2 x T 16
    (torch.bfloat16, 24, 64, 64, "tensor_core"),     # ragged fold, G 3 x T 8
    (torch.bfloat16, 40, 128, 128, "tensor_core"),   # verify T 5 at G 8
    (torch.bfloat16, 16, 128, 64, "tensor_core"),
    (torch.bfloat16, 128, 64, 64, "tensor_core"),    # 8 M-tiles, the most a block takes
    (torch.bfloat16, 128, 64, 128, "tensor_core"),
    (torch.bfloat16, 96, 128, 128, "tensor_core"),   # 6 M-tiles: the most that fit at 128
    (torch.bfloat16, 97, 128, 128, "cuda_core"),
    (torch.bfloat16, 128, 128, 128, "cuda_core"),    # qwen2-72b's prefill, G 8 x T 16
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
    (torch.bfloat16, 9, 64, 64, "cuda_core"),        # verify spec_k 8, the reference bench's
    (torch.bfloat16, 1, 576, 512, "cuda_core"),      # MLA decode
    (torch.float32, 1, 576, 512, "cuda_core"),
    (torch.bfloat16, 1, 32, 32, "cuda_core"),
    (torch.float32, 16, 128, 128, "cuda_core"),      # f32 chunk-extend
    (torch.bfloat16, 15, 64, 64, "cuda_core"),
    (torch.bfloat16, 136, 64, 64, "cuda_core"),
    (torch.bfloat16, 16, 576, 512, "cuda_core"),     # MLA
    (torch.bfloat16, 16, 32, 32, "cuda_core"),
    (torch.bfloat16, 16, 64, 48, "cuda_core"),
    (torch.float32, 16, 64, 64, "cuda_core"),        # f32 parity
    (torch.float32, 40, 128, 128, "cuda_core"),
    # ds-paper-100m's verify (G 1, T = spec_k + 1) and its draft's catch-up
    (torch.bfloat16, 5, 64, 64, "decode"),           # spec_k 4
    (torch.float32, 5, 64, 64, "decode"),
    (torch.bfloat16, 8, 64, 64, "decode"),           # spec_k 7, the decode path's last
    (torch.float32, 9, 64, 64, "cuda_core"),         # spec_k 8; its bf16 row is listed earlier
    (torch.bfloat16, 32, 64, 64, "tensor_core"),     # the draft's catch-up chunk
    (torch.float32, 32, 64, 64, "cuda_core"),
])
def test_paged_kernel_path_table(dtype, ql, dk, dv, path):
    assert flash_decode.kernel_path(dtype, ql, dk, dv) == path


def test_tensor_core_calls_fit_the_blocks_shared_memory():
    """Every call routed to the tensor-core path fits the C launcher's
    budget (``run_tc``: a warp per M-tile, at most 8, each with a 2-stage
    ring of 32-key K and V units, rows padded by 8 bf16, or the warps'
    merge slots, within the H100's 227 KiB a block); the next fold past
    ``tensor_core_rows`` goes to the CUDA cores.  A call routed past it
    failed to launch on the card (qwen2-72b's bf16 prefill, G*T 128 at
    dk = dv = 128: 272 KiB)."""
    for dk in (64, 128):
        for dv in (64, 128):
            rows = flash_decode.tensor_core_rows(dk, dv)
            assert flash_decode.kernel_path(torch.bfloat16, rows + 1, dk, dv) == "cuda_core"
            for ql in range(16, rows + 1):
                assert flash_decode.kernel_path(torch.bfloat16, ql, dk, dv) == "tensor_core"
                nw = -(-ql // 16)
                ring = nw * 2 * 32 * (dk + 8 + dv + 8) * 2
                merge = nw * (32 + 16 * dv) * 4
                assert nw <= 8 and max(ring, merge) <= 227 * 1024, (ql, dk, dv)
    assert flash_decode.tensor_core_rows(128, 128) == 96
    assert flash_decode.tensor_core_rows(64, 64) == flash_decode.tensor_core_rows(64, 128) == 128


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
