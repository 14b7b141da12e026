"""The paged-attention kernel's two paths: which calls take the bf16
tensor-core path (``flash_decode.kernel_path``), and the plain version
that ``chip_smoke.py`` holds that path to, against the reference package
(its kernel in interpret mode and its oracle) at the path's shapes, on
identical numpy inputs, at the bf16 tolerance (2e-2)."""

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
    (torch.bfloat16, 1, 64, 64, "cuda_core"),        # decode
    (torch.bfloat16, 8, 128, 128, "cuda_core"),      # GQA decode, G 8
    (torch.bfloat16, 15, 64, 64, "cuda_core"),
    (torch.bfloat16, 136, 64, 64, "cuda_core"),
    (torch.bfloat16, 16, 576, 512, "cuda_core"),     # MLA
    (torch.bfloat16, 16, 32, 32, "cuda_core"),
    (torch.bfloat16, 16, 64, 48, "cuda_core"),
    (torch.float32, 16, 64, 64, "cuda_core"),        # f32 parity
    (torch.float32, 40, 128, 128, "cuda_core"),
])
def test_paged_kernel_path_table(dtype, ql, dk, dv, path):
    assert flash_decode.kernel_path(dtype, ql, dk, dv) == path
