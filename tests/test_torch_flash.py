"""The flash-attention op (plain path on the CPU) against the reference
package on identical numpy inputs: the reference's sweep, sliding
windows and model layout against its kernel in interpret mode and its
oracles, at its tolerances (2e-5 f32, 2e-2 bf16, 3e-5 in the model
layout); direct attention's options; the block contract and the missing
gradient."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bhsd as jflash
from repro.models.layers import attention_scores as jattention_scores
from repro_torch.kernels import flash_attention, ops, ref
from repro_torch.models.layers import attention_scores

torch.set_num_threads(1)  # the test workers share the host's cores

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def both(a: np.ndarray, name="float32"):
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(shape, name, seed=0):
    rng = np.random.default_rng(seed)
    return [both(rng.standard_normal(shape).astype(np.float32), name) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,hd,block", [(2, 128, 64, 64), (1, 256, 128, 128),
                                           (3, 512, 64, 256), (2, 128, 192, 64),
                                           # a ragged last 128-row tile of the CUDA kernel
                                           (2, 192, 64, 64), (1, 320, 64, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sweep(bh, s, hd, block, causal, dtype):
    """The reference's sweep: the port's wrapper (its plain version on the
    CPU) against the reference's kernel in interpret mode and its oracle."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv((bh, s, hd), dtype)
    got = flash_attention.flash_attention_bhsd(tq, tk, tv, causal=causal, block_q=block,
                                               block_k=block)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want_kernel = jflash(jq, jk, jv, causal=causal, block_q=block, block_k=block, interpret=True)
    for want in (want_kernel, jref.attention_reference(jq, jk, jv, causal=causal),
                 ref.attention_reference(tq, tk, tv, causal=causal)):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_sliding_window(window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv((2, 256, 64), "float32", seed=1)
    got = flash_attention.flash_attention_bhsd(tq, tk, tv, causal=True, window=window,
                                               block_q=64, block_k=64)
    want = jflash(jq, jk, jv, causal=True, window=window, block_q=64, block_k=64,
                  interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        f32(got), f32(jref.attention_reference(jq, jk, jv, causal=True, window=window)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [32, 128])
@pytest.mark.parametrize("s", [192, 320])
def test_flash_attention_sliding_window_ragged(s, window):
    """Windows over sequences whose last 128-row tile of the CUDA kernel
    is ragged, in both dtypes, against the reference's kernel."""
    for dtype in ("float32", "bfloat16"):
        (jq, tq), (jk, tk), (jv, tv) = _qkv((2, s, 64), dtype, seed=s + window)
        got = flash_attention.flash_attention_bhsd(tq, tk, tv, causal=True, window=window,
                                                   block_q=64, block_k=64)
        want = jflash(jq, jk, jv, causal=True, window=window, block_q=64, block_k=64,
                      interpret=True)
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


def test_flash_attention_model_layout():
    (jq, tq), (jk, tk), (jv, tv) = _qkv((2, 128, 4, 64), "float32", seed=2)
    got = ops.flash_attention(tq, tk, tv, causal=True, block_q=64, block_k=64)
    want = jops.flash_attention(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-5, atol=3e-5)
    for want in (jattention_scores(jq, jk, jv, causal=True),
                 attention_scores(tq, tk, tv, causal=True),
                 ref.ORACLES["flash_attention"](tq, tk, tv, causal=True)):
        np.testing.assert_allclose(f32(got), f32(want), rtol=3e-5, atol=3e-5)


def test_attention_scores_options_match_reference():
    """Direct attention's positions, window, KV mask and softcap."""
    rng = np.random.default_rng(6)
    (jq, tq), (jk, tk), (jv, tv) = _qkv((2, 5, 4, 16), "float32", seed=6)
    qpos = np.asarray([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    kvpos = np.tile(np.arange(5, dtype=np.int32), (2, 1)) + np.asarray([[2], [0]], np.int32)
    kv_mask = rng.random((2, 5)) > 0.2
    kv_mask[:, 0] = True
    kw = dict(causal=True, sliding_window=3, logit_softcap=5.0)
    want = jattention_scores(jq, jk, jv, q_positions=jnp.asarray(qpos),
                             kv_positions=jnp.asarray(kvpos), kv_mask=jnp.asarray(kv_mask), **kw)
    got = attention_scores(tq, tk, tv, q_positions=torch.from_numpy(qpos),
                           kv_positions=torch.from_numpy(kvpos),
                           kv_mask=torch.from_numpy(kv_mask), **kw)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


def test_flash_wrapper_keeps_the_block_contract_and_has_no_gradient():
    q = torch.zeros((1, 96, 64))
    with pytest.raises(ValueError, match="must divide blocks"):
        flash_attention.flash_attention_bhsd(q, q, q, block_q=64, block_k=64)
    q = torch.randn((1, 64, 64), requires_grad=True)
    out = flash_attention.flash_attention_bhsd(q, q, q)
    with pytest.raises(NotImplementedError, match="no backward"):
        out.sum().backward()


# ---------------------------------------------- the f32 kernel's arithmetic
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero (half of the last kept bit is added to the
    magnitude, then the 13 low mantissa bits are cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel forms it: each operand split into hi (its
    TF32 rounding) and lo (the rest, rounded to TF32), and the products
    lo.hi + hi.lo + hi.hi summed in fp32 (lo.lo dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _attention_3xtf32(q, k, v, causal, window=0, tf32_only=False):
    """Masked softmax attention with both products in 3xTF32 (or in plain
    TF32 with ``tf32_only``), the probabilities unnormalised through P.V
    and divided by the fp32 row sum after, as the f32 kernel does."""
    mm = (lambda a, b: _tf32(a) @ _tf32(b)) if tf32_only else _mm_3xtf32
    sq, hd = q.shape[1], q.shape[2]
    s = mm(q, k.transpose(1, 2)) * (1.0 / math.sqrt(hd))
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(k.shape[1])[None, :]
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True)


F32_ARITH_CASES = [(bh, s, hd, causal, 0) for bh, s, hd in ((2, 128, 64), (1, 256, 128),
                                                           (3, 512, 64), (2, 128, 192),
                                                           (2, 192, 64), (1, 320, 64))
                   for causal in (True, False)]
F32_ARITH_CASES += [(2, 320, 64, True, 128), (1, 1024, 64, True, 0)]
# h2o-danube-3-4b's head width 120 (the kernel pads its depth to 128 with
# zeros, which leaves every product unchanged): causal, full and windowed
F32_ARITH_CASES += [(2, 256, 120, True, 0), (2, 256, 120, False, 0), (1, 320, 120, True, 64)]


@pytest.mark.parametrize("bh,s,hd,causal,window", F32_ARITH_CASES)
def test_flash_f32_3xtf32_arithmetic_meets_the_gate(bh, s, hd, causal, window):
    """The f32 kernel's 3xTF32 split, emulated on the CPU with TF32 rounding
    by integer bit arithmetic, holds the reference at the f32 gate (2e-5)
    over the sweep's f32 shapes, a window, causal S 1024 and head width
    120; plain TF32 misses it."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv((bh, s, hd), "float32", seed=s + hd + window)
    want = f32(jref.attention_reference(jq, jk, jv, causal=causal, window=window))
    got = _attention_3xtf32(tq, tk, tv, causal, window)
    np.testing.assert_allclose(f32(got), want, rtol=2e-5, atol=2e-5)
    rough = _attention_3xtf32(tq, tk, tv, causal, window, tf32_only=True)
    assert not np.allclose(f32(rough), want, rtol=2e-5, atol=2e-5)
