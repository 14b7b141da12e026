"""The SSD chunk op (plain path on the CPU) against the reference package
on identical numpy inputs: ``ssd_chunk_plain`` against
``ref.ssd_chunk_reference`` and ``ssd_chunk_pallas(interpret=True)`` on
the reference's sweep (2e-5 f32, 2e-2 bf16); the model-layout
``ops.ssd`` against the reference's ``ops.ssd`` in interpret mode with a
carried state and padded (dt = 0) tokens (states at 1e-3, as the
reference's own test); the sequential recurrence; the running sum in the
reference's rounding; and the wrapper's refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_chunk_pallas
from repro.models.ssm import ssd_decode_step as jssd_decode_step
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.models.ssm import ssd_chunked, ssd_decode_step

torch.set_num_threads(1)  # the test workers share the host's cores

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWEEP = [  # tests/test_kernels.py::test_ssd_kernel_sweep
    (2, 64, 4, 16, 16, 16, 2),
    (1, 128, 8, 32, 32, 32, 4),
    (2, 256, 16, 64, 128, 128, 8),  # mamba2-1.3b tile shape
]


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def inputs(b, l, h, p, n, seed=0, lengths=None):
    """The sweep's distributions from numpy: x, B, C ~ N(0, 1),
    dt = softplus(N(0, 1)), A = -exp(N(0, 1) / 2); ``lengths`` zeroes dt
    past each row's valid tokens (padded prefill tokens)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h)), 0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    if lengths is not None:
        dt = dt * (np.arange(l)[None, :] < np.asarray(lengths)[:, None])[..., None]
    return x, dt, A, B, C


def as_jax(a, name="float32"):
    return jnp.asarray(a, DTYPES[name][0])


def as_torch(a, name="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(DTYPES[name][1])


def chunked(x, dt, A, B, C, chunk):
    """The kernel's per-chunk operands (what ``ops.ssd`` hands it)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    return (x.reshape(b, nc, chunk, h, p), (dt * A).reshape(b, nc, chunk, h),
            dt.reshape(b, nc, chunk, h), B.reshape(b, nc, chunk, n), C.reshape(b, nc, chunk, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk,block_h", SWEEP)
def test_ssd_chunk_plain_matches_reference(b, l, h, p, n, chunk, block_h, dtype):
    xr, dAr, dtr, Br, Cr = chunked(*inputs(b, l, h, p, n), chunk)
    jargs = (as_jax(xr, dtype), as_jax(dAr), as_jax(dtr), as_jax(Br, dtype), as_jax(Cr, dtype))
    targs = (as_torch(xr, dtype), as_torch(dAr), as_torch(dtr), as_torch(Br, dtype),
             as_torch(Cr, dtype))
    y, st = ssd_mod.ssd_chunk(*targs, block_h=block_h)
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == xr.shape and st.shape == (b, l // chunk, h, p, n)
    for want in (jref.ssd_chunk_reference(*jargs),
                 ssd_chunk_pallas(*jargs, block_h=block_h, interpret=True)):
        np.testing.assert_allclose(f32(y), f32(want[0]), **tol(dtype))
        np.testing.assert_allclose(f32(st), f32(want[1]), **tol(dtype))
    got = ref.ssd_chunk_reference(*targs)
    np.testing.assert_array_equal(f32(got[0]), f32(y))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk,block_h", SWEEP)
def test_ssd_op_with_carried_state_and_padding_matches_reference(b, l, h, p, n, chunk, block_h,
                                                                 dtype):
    """ops.ssd from a carried state, rows padded past their valid tokens
    (dt = 0), against the reference's ops.ssd (interpret mode) and its
    ssd_chunked; the op's oracle is the model's plain chunked scan."""
    lengths = [l - l // 3 - 1, l][:b]
    x, dt, A, B, C = inputs(b, l, h, p, n, seed=1, lengths=lengths)
    init = np.random.default_rng(2).standard_normal((b, h, p, n)).astype(np.float32)
    jx, jB, jC = as_jax(x, dtype), as_jax(B, dtype), as_jax(C, dtype)
    jy, jfinal = jops.ssd(jx, as_jax(dt), as_jax(A), jB, jC, chunk=chunk, block_h=block_h,
                          initial_state=as_jax(init), interpret=True)
    tx, tB, tC = as_torch(x, dtype), as_torch(B, dtype), as_torch(C, dtype)
    y, final = ops.ssd(tx, as_torch(dt), as_torch(A), tB, tC, chunk=chunk, block_h=block_h,
                       initial_state=as_torch(init))
    assert y.dtype == tx.dtype and final.dtype == torch.float32
    np.testing.assert_allclose(f32(y), f32(jy), **tol(dtype))
    np.testing.assert_allclose(f32(final), f32(jfinal), rtol=1e-3, atol=1e-3)
    oy, ofinal = ref.ORACLES["ssd"](tx, as_torch(dt), as_torch(A), tB, tC, chunk,
                                    initial_state=as_torch(init))
    np.testing.assert_allclose(f32(y), f32(oy), **tol(dtype))
    np.testing.assert_allclose(f32(final), f32(ofinal), rtol=1e-3, atol=1e-3)


def test_ssd_op_without_state_matches_reference_chunked_scan():
    x, dt, A, B, C = inputs(2, 64, 4, 16, 16, seed=3)
    jy, jfinal = jref.ssd_reference(*(as_jax(a) for a in (x, dt, A, B, C)), 16)
    y, final = ops.ssd(*(as_torch(a) for a in (x, dt, A, B, C)), chunk=16, block_h=3)
    np.testing.assert_allclose(f32(y), f32(jy), **tol("float32"))
    np.testing.assert_allclose(f32(final), f32(jfinal), rtol=1e-3, atol=1e-3)


def test_ssd_op_matches_sequential_recurrence():
    """Chunk op + glue == the per-token recurrence (test_kernels.py's
    check), and the port's decode step == the reference's."""
    b, l, h, p, n, chunk = 1, 32, 2, 8, 8, 8
    x, dt, A, B, C = inputs(b, l, h, p, n, seed=4)
    A = (-np.exp(np.random.default_rng(5).standard_normal(h) * 0.3)).astype(np.float32)
    tx, tdt, tA, tB, tC = (as_torch(a) for a in (x, dt, A, B, C))
    y, final = ops.ssd(tx, tdt, tA, tB, tC, chunk=chunk)
    state = torch.zeros((b, h, p, n))
    jstate = jnp.zeros((b, h, p, n))
    ys = []
    for t in range(l):
        yt, state = ssd_decode_step(state, tx[:, t], tdt[:, t], tA, tB[:, t], tC[:, t])
        jyt, jstate = jssd_decode_step(jstate, *(as_jax(a[:, t]) for a in (x, dt)), as_jax(A),
                                       *(as_jax(a[:, t]) for a in (B, C)))
        np.testing.assert_allclose(f32(yt), f32(jyt), rtol=1e-5, atol=1e-5)
        ys.append(yt)
    np.testing.assert_allclose(f32(y), f32(torch.stack(ys, dim=1)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(final), f32(state), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(state), f32(jstate), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 64, 128, 300])
def test_blocked_cumsum_equals_the_reference_cumsum(n):
    """The running sum in the reference's rounding, bit for bit: a plain
    in-order float32 cumsum differs from it by ulps, which exp(cum_i -
    cum_j) carries into the result beyond 2e-5."""
    a = (np.random.default_rng(n).standard_normal((3, 2, n)) * 3).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(a), axis=-1))
    np.testing.assert_array_equal(ssd_mod.blocked_cumsum(torch.from_numpy(a), -1).numpy(), want)
    want1 = np.asarray(jnp.cumsum(jnp.asarray(a.transpose(0, 2, 1)), axis=1))
    got1 = ssd_mod.blocked_cumsum(torch.from_numpy(a.transpose(0, 2, 1).copy()), 1)
    np.testing.assert_array_equal(got1.numpy(), want1)


def test_model_chunked_scan_matches_reference_ssd_chunked():
    x, dt, A, B, C = inputs(2, 96, 4, 16, 16, seed=6)
    init = np.random.default_rng(7).standard_normal((2, 4, 16, 16)).astype(np.float32)
    from repro.models.ssm import ssd_chunked as jssd_chunked

    jy, jfinal = jssd_chunked(*(as_jax(a) for a in (x, dt, A, B, C)), 32,
                              initial_state=as_jax(init))
    y, final = ssd_chunked(*(as_torch(a) for a in (x, dt, A, B, C)), 32,
                           initial_state=as_torch(init))
    np.testing.assert_allclose(f32(y), f32(jy), **tol("float32"))
    np.testing.assert_allclose(f32(final), f32(jfinal), rtol=1e-5, atol=1e-5)


def _small(dtype=torch.float32):
    xr, dAr, dtr, Br, Cr = chunked(*inputs(1, 32, 4, 16, 16, seed=8), 16)
    return (as_torch(xr).to(dtype), as_torch(dAr), as_torch(dtr), as_torch(Br).to(dtype),
            as_torch(Cr).to(dtype))


def test_ssd_wrapper_refuses_what_it_does_not_take():
    x, dA, dt, B, C = _small()
    with pytest.raises(ValueError, match="must divide"):
        ssd_mod.ssd_chunk(x, dA, dt, B, C, block_h=3)
    with pytest.raises(ValueError, match="shapes disagree"):
        ssd_mod.ssd_chunk(x, dA, dt, B[..., :8], C, block_h=2)
    with pytest.raises(ValueError, match=r"x \(b, nc, q, h, p\)"):
        ssd_mod.ssd_chunk(x[0], dA, dt, B, C)
    with pytest.raises(ValueError, match="CUDA device"):  # the kernel path takes CUDA only
        ssd_mod._launch(x, dA, dt, B, C, 2)
    with pytest.raises(ValueError, match="!% chunk"):
        ops.ssd(x.reshape(1, 32, 4, 16), dt.reshape(1, 32, 4), torch.ones(4),
                B.reshape(1, 32, 16), C.reshape(1, 32, 16), chunk=12)


def test_ssd_shared_memory_matches_the_kernel_budget():
    """The wrapper's shared-memory count (csrc/ssd.cu's layout: B and C,
    head slots of one head's x and sums, rows padded) admits mamba2-1.3b's
    tile (q 128, p 64, n 128, 8 heads a block) in both types and every
    instantiation at the largest chunk.  bf16 keeps no S or f32 x in shared
    memory: 109,568 bytes at that tile, two blocks an SM by shared memory
    (its 168 registers a thread hold it to one); f32 one.  A short chunk
    (serving prefill, q 16) gives every head its slot; a long one streams
    through two, where all heads would take more than half a block's
    limit, so ``ops.ssd``'s fallback ``block_h = h`` launches at h = 64."""
    bf16, f32_ = torch.bfloat16, torch.float32

    def blocks_per_sm(*args):  # an H100 SM's 233,472 bytes, 1,024 kept a block
        return 233_472 // (ssd_mod.smem_bytes(*args) + 1_024)

    assert ssd_mod.head_slots(128, 64, 128, bf16, 8) == 2
    assert ssd_mod.smem_bytes(128, 64, 128, bf16, 8) == 128 * (2 * 136 * 2 + 2 * (72 * 2 + 12))
    assert ssd_mod.smem_bytes(128, 64, 128, bf16, 8) == 109_568
    assert ssd_mod.smem_bytes(128, 64, 128, f32_, 8) == 128 * (2 * 132 * 4 + 2 * (68 * 4 + 12))
    assert blocks_per_sm(128, 64, 128, bf16, 8) == 2
    assert blocks_per_sm(128, 64, 128, f32_, 8) == 1
    # all 8 bf16 heads would fit a block at q 128, but not in half of it
    assert ssd_mod._smem(128, 64, 128, 2, 8) <= ssd_mod.SMEM_LIMIT < 2 * ssd_mod._smem(128, 64, 128, 2, 8)
    assert ssd_mod.head_slots(16, 64, 128, bf16, 8) == 8
    assert ssd_mod.head_slots(16, 64, 128, f32_, 8) == 8
    assert blocks_per_sm(16, 64, 128, bf16, 8) >= 2
    for dtype in (bf16, f32_):
        assert ssd_mod.smem_bytes(128, 64, 128, dtype, 64) == ssd_mod.smem_bytes(128, 64, 128,
                                                                                  dtype, 8)
        for p in ssd_mod.HEAD_DIMS:
            for n in ssd_mod.STATE_DIMS:
                for block_h in (1, 2, 8, 64):
                    assert ssd_mod.smem_bytes(ssd_mod.MAX_CHUNK, p, n, dtype,
                                              block_h) <= ssd_mod.SMEM_LIMIT
    assert ssd_mod.smem_bytes(16, 64, 128, bf16, 8) < 48 * 1024
    assert ssd_mod.smem_bytes(7, 64, 128, bf16, 8) == ssd_mod.smem_bytes(16, 64, 128, bf16, 8)


# ---------------------------------------------- the kernel's arithmetic
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as the kernel's integer split rounds it: to
    nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16_parts(x: torch.Tensor, k: int) -> list:
    """``x`` (fp32) as ``k`` bf16 parts, largest first, each the rounding
    of what the parts before leave (each remainder exact in fp32)."""
    parts = []
    for _ in range(k):
        parts.append(x.bfloat16().float())
        x = x - parts[-1]
    return parts


def _products(eq: str, a: torch.Tensor, b: torch.Tensor, how: str) -> torch.Tensor:
    """``einsum(eq, a, b)`` over one summed index as the kernel forms it:
    ``in_order`` a chain of fp32 fused multiply-adds in order (each step
    exact in float64, then rounded once to fp32) on the CUDA cores; on the
    tensor cores ``3xtf32`` with both split into TF32 hi and lo (lo.hi +
    hi.lo + hi.hi), ``tf32`` one plain TF32 pass, sums in fp32; in bf16
    ``exact`` the operands as they are (bf16 values: exact products, fp32
    sums) and ``bf16xK`` ``a`` in K bf16 parts against ``b`` (bf16 values,
    exact), the small parts first."""
    if how == "in_order":
        ins, out = eq.split("->")
        ea, eb = ins.split(",")
        k = next(ch for ch in ea if ch in eb and ch not in out)
        a_, b_ = a.movedim(ea.index(k), 0), b.movedim(eb.index(k), 0)
        inner = f"{ea.replace(k, '')},{eb.replace(k, '')}->{out}"
        acc = None
        for i in range(a_.shape[0]):
            term = torch.einsum(inner, a_[i].double(), b_[i].double())
            acc = term.float() if acc is None else (acc.double() + term).float()
        return acc
    if how == "tf32":
        return torch.einsum(eq, _tf32(a), _tf32(b))
    if how == "exact":
        return torch.einsum(eq, a, b)
    if how.startswith("bf16x"):
        acc = None
        for part in reversed(_bf16_parts(a, int(how[5:]))):
            term = torch.einsum(eq, part, b)
            acc = term if acc is None else acc + term
        return acc
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


# csrc/ssd.cu's routes: (how S = C.B^T is formed, how M.x and (w x)^T.B are)
ROUTES = {
    "f32": ("in_order", "3xtf32"),  # the kernel's f32 route
    "f32_plain_tf32": ("in_order", "tf32"),  # one TF32 pass: misses the f32 gate
    "bf16": ("exact", "bf16x3"),  # the kernel's bf16 route: M and w x in three bf16 parts
    "bf16_two_parts": ("exact", "bf16x2"),  # misses the bf16 gate
}
SSD_BF16_TOL = dict(rtol=1e-4, atol=1e-4)  # chip_smoke.py holds the bf16 kernel to it too


def _ssd_kernel_arithmetic(x, dA, dt, B, C, route):
    """``(Y_diag, states)`` with the rounding of one of csrc/ssd.cu's routes
    (``ROUTES``): M = S exp(cum_i - cum_j) dt_j and w x in fp32, then the
    products as the route forms them."""
    s_how, how = ROUTES[route]
    xf, Bf, Cf = x.float(), B.float(), C.float()
    cum = ssd_mod.blocked_cumsum(dA, 2)
    q = x.shape[2]
    S = _products("bcin,bcjn->bcij", Cf, Bf, s_how)
    ar = torch.arange(q)
    tri = (ar[None, :] <= ar[:, None])[None, None, :, :, None]
    L = torch.where(tri, torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :]),
                    torch.zeros(()))
    M = S[..., None] * L * dt[:, :, None, :, :]
    y = _products("bcijh,bcjhp->bcihp", M, xf, how)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt
    st = _products("bcjhp,bcjn->bchpn", xf * w[..., None], Bf, how)
    return y, st


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk,block_h", SWEEP + [(1, 128, 2, 64, 128, 128, 2)])
def test_ssd_kernel_arithmetic_meets_the_gate(b, l, h, p, n, chunk, block_h, dtype):
    """The Hopper kernel's rounding, emulated in plain torch, against the
    reference kernel (interpret mode) at the gate the card holds it to
    (2e-5 f32, 1e-4 bf16): f32 (in-order C.B^T, 3xTF32 products) and bf16
    (tensor-core C.B^T, M and w x in three bf16 parts).  In f32 one plain
    TF32 pass would miss the gate; in bf16 the plain outputs rounded to
    bf16 miss it in every case, as two parts do at mamba2-1.3b's tile."""
    xr, dAr, dtr, Br, Cr = chunked(*inputs(b, l, h, p, n, seed=9), chunk)
    jargs = (as_jax(xr, dtype), as_jax(dAr), as_jax(dtr), as_jax(Br, dtype), as_jax(Cr, dtype))
    want = ssd_chunk_pallas(*jargs, block_h=block_h, interpret=True)
    targs = (as_torch(xr, dtype), as_torch(dAr), as_torch(dtr), as_torch(Br, dtype),
             as_torch(Cr, dtype))
    route = "f32" if dtype == "float32" else "bf16"
    gate = tol(dtype) if dtype == "float32" else SSD_BF16_TOL

    def holds(outs):
        return all(np.allclose(f32(g), f32(r), **gate) for g, r in zip(outs, want))

    for got, ref_out in zip(_ssd_kernel_arithmetic(*targs, route), want):
        np.testing.assert_allclose(f32(got), f32(ref_out), **gate)
    if dtype == "float32":
        assert not holds(_ssd_kernel_arithmetic(*targs, "f32_plain_tf32"))
    else:
        assert not holds([o.bfloat16() for o in ssd_mod.ssd_chunk_plain(*targs)])
        if (b, l, h, p, n, chunk) == (2, 256, 16, 64, 128, 128):
            assert not holds(_ssd_kernel_arithmetic(*targs, "bf16_two_parts"))


def test_ssd_backward_raises_and_plain_path_launches_nothing(monkeypatch):
    def boom():
        raise AssertionError("kernel library touched on the CPU path")

    monkeypatch.setattr(_build, "library", boom)
    before = ssd_mod.ssd_chunk.launches
    x, dA, dt, B, C = _small()
    x.requires_grad_(True)
    y, st = ssd_mod.ssd_chunk(x, dA, dt, B, C, block_h=2)
    assert ssd_mod.ssd_chunk.launches == before
    with pytest.raises(NotImplementedError, match="no backward"):
        (y.sum() + st.sum()).backward()
