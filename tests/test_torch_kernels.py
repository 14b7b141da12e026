"""Port kernels (plain path on the CPU) against the reference package:
``repro_torch.kernels.ops`` vs ``repro.kernels.ops`` in interpret mode
and vs ``repro.kernels.ref``, on identical numpy inputs, at the
reference's tolerances (2e-5 f32, 2e-2 bf16); the RMSNorm op's
analytic gradient by ``gradcheck``; and the wrappers' shared state under
worker threads: launch counts stay exact and the decode path's scratch
never shrinks under a caller that needs it."""

import inspect
import math
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, flash_attention, flash_decode, ops, ref
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.kernels import ssd as ssd_mod

torch.set_num_threads(1)  # the test workers share the host's cores

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def both(a: np.ndarray, name="float32"):
    """The same numpy array as a JAX and a torch array of one dtype."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _alloc_table(B, P, n_pages, frontiers, ps, seed=1):
    """Disjoint physical pages per row covering each row's frontier; the
    sentinel ``n_pages`` everywhere else (as ``tests/test_kernels.py``)."""
    rng = np.random.default_rng(seed)
    perm = list(rng.permutation(n_pages))
    table = np.full((B, P), n_pages, np.int32)
    for b, frontier in enumerate(frontiers):
        for j in range(-(-frontier // ps)):
            table[b, j] = perm.pop()
    return table


def _paged_case(B, T, hkv, g, dk, ps, P, n_pages, offsets, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n_pages, ps, hkv, dk)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, hkv, dv or dk)).astype(np.float32)
    q = rng.standard_normal((B, T, hkv * g, dk)).astype(np.float32)
    table = _alloc_table(B, P, n_pages, np.asarray(offsets) + T, ps)
    return q, k, v, table, np.asarray(offsets, np.int32)


def _run_both(q, k, v, table, offs, dtype="float32", **kw):
    jq, tq = both(q, dtype)
    jk, tk = both(k, dtype)
    jv, tv = both(v, dtype)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jo, to = jnp.asarray(offs), torch.from_numpy(offs)
    got = ops.paged_attention(tq, tk, tv, tt, to, **kw)
    want_kernel = jops.paged_attention(jq, jk, jv, jt, jo, interpret=True, **kw)
    want_ref = jref.paged_attention_reference(jq, jk, jv, jt, jo, **kw)
    port_ref = ref.paged_attention_reference(tq, tk, tv, tt, to, **kw)
    return got, want_kernel, want_ref, port_ref


# ------------------------------------------------- paged flash decode/extend
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 4])  # flash-decode and chunk-extend
@pytest.mark.parametrize("hkv,g", [(2, 4), (1, 8)])  # GQA and MLA-style Hkv=1
def test_paged_attention_vs_reference(T, hkv, g, dtype):
    case = _paged_case(B=3, T=T, hkv=hkv, g=g, dk=32, ps=8, P=4, n_pages=10,
                       offsets=[5, 0, 9])
    got, want_kernel, want_ref, port_ref = _run_both(*case, dtype=dtype)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (3, T, hkv * g, 32)
    for want in (want_kernel, want_ref, port_ref):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("k", [1, 3])  # draft window sizes
def test_paged_verify_vs_reference(k):
    """``paged_verify`` on its own contract: k+1 candidate queries per row
    against the accepted history, against the reference's verify entry
    and the registered oracle."""
    T = k + 1
    q, kk, v, table, offs = _paged_case(B=3, T=T, hkv=2, g=4, dk=32, ps=8, P=4,
                                        n_pages=12, offsets=[5, 0, 9], seed=7)
    tt = [torch.from_numpy(x) for x in (q, kk, v, table, offs)]
    jj = [jnp.asarray(x) for x in (q, kk, v, table, offs)]
    got = ops.paged_verify(*tt)
    np.testing.assert_allclose(f32(got), f32(jops.paged_verify(*jj, interpret=True)),
                               rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(f32(got), f32(ref.ORACLES["paged_verify"](*tt)),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("softcap,dv,v_width", [(30.0, 32, 0), (0.0, 48, 32), (5.0, 48, 40)])
def test_paged_attention_softcap_and_v_width(softcap, dv, v_width):
    """The kernel contract's two options the dense slice does not use:
    tanh softcap on the scores and values read from the first
    ``v_width`` columns of a wider (MLA-style) page."""
    case = _paged_case(B=3, T=4, hkv=1, g=8, dk=32, ps=8, P=4, n_pages=10,
                       offsets=[5, 0, 9], seed=3, dv=dv)
    got, want_kernel, want_ref, port_ref = _run_both(*case, softcap=softcap, v_width=v_width)
    assert got.shape[-1] == (v_width or dv)
    for want in (want_kernel, want_ref, port_ref):
        np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


def test_paged_attention_matches_contiguous_reference():
    """Pages laid out contiguously == plain causal attention over the
    logical sequence: the page indirection is position-exact."""
    B, T, h, dk, ps = 2, 8, 4, 16, 4
    seq = 16
    P = seq // ps
    rng = np.random.default_rng(3)
    table = np.arange(B * P, dtype=np.int32).reshape(B, P)
    kv = rng.standard_normal((B, seq, h, dk)).astype(np.float32)
    vv = rng.standard_normal((B, seq, h, dk)).astype(np.float32)
    q = rng.standard_normal((B, T, h, dk)).astype(np.float32)
    offsets = np.full((B,), seq - T, np.int32)
    out = ops.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kv.reshape(B * P, ps, h, dk)),
        torch.from_numpy(vv.reshape(B * P, ps, h, dk)), torch.from_numpy(table),
        torch.from_numpy(offsets),
    )
    full_q = rng.standard_normal((B, seq, h, dk)).astype(np.float32)
    full_q[:, seq - T:] = q
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * h, -1, dk)  # noqa: E731
    want = jref.attention_reference(fold(full_q), fold(kv), fold(vv), causal=True)
    want = np.asarray(want).reshape(B, h, seq, dk).transpose(0, 2, 1, 3)[:, seq - T:]
    np.testing.assert_allclose(f32(out), want, rtol=2e-5, atol=2e-5)


def test_paged_attention_parked_rows_are_finite_zero():
    """Rows whose pages were all freed (sentinel everywhere) produce exact
    zeros, not NaNs."""
    B, T, h, dk, ps, P, n_pages = 2, 1, 4, 16, 8, 4, 6
    rng = np.random.default_rng(4)
    k = torch.from_numpy(rng.standard_normal((n_pages, ps, h, dk)).astype(np.float32))
    table = np.full((B, P), n_pages, np.int32)
    table[0, 0] = 2  # row 0 live, row 1 parked
    q = torch.from_numpy(rng.standard_normal((B, T, h, dk)).astype(np.float32))
    out = ops.paged_attention(q, k, k, torch.from_numpy(table),
                              torch.tensor([3, 3], dtype=torch.int32))
    assert torch.isfinite(out).all()
    assert (out[1] == 0).all()
    assert (out[0] != 0).any()


def test_paged_wrapper_rejects_bad_fold():
    q = torch.zeros((1, 2, 5, 16))
    pages = torch.zeros((4, 8, 2, 16))
    with pytest.raises(ValueError, match="fold"):
        flash_decode.paged_flash_attention_folded(
            q, pages, pages, torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32), tokens_per_row=2)


# ------------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# 2048, 3840 and 4096 (zamba2's shared block) are compiled into the kernel's one-pass path,
# and internvl2-1b's 896
@pytest.mark.parametrize("shape", [(4, 256), (2, 8, 512), (3, 5, 128), (37, 100), (3, 8192),
                                   (16, 2048), (4, 3840), (16, 4096), (256, 4096), (16, 896),
                                   (256, 896)])
def test_rmsnorm_sweep(shape, dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    jx, tx = both(x, dtype)
    got = ops.rmsnorm(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want_kernel = jops.rmsnorm(jx, jnp.asarray(w), interpret=True)
    want_ref = jref.rmsnorm_reference(jx, jnp.asarray(w))
    for want in (want_kernel, want_ref, ref.rmsnorm_reference(tx, torch.from_numpy(w))):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


ONE_PASS_WIDTHS = (512, 768, 896, 1536, 2048, 3840, 4096, 5120, 6144, 8192, 18432)


def test_rmsnorm_one_pass_widths_are_the_served_ones():
    """The widths ``csrc/rmsnorm.cu`` compiles into its one pass (its
    ``case`` labels) are the served models' norm widths, and the set
    ``chip_smoke.py`` holds each launch's reported path to."""
    import ast
    import re

    from repro_torch.configs import get_arch

    src = (_build.CSRC / "rmsnorm.cu").read_text()
    compiled = tuple(sorted(int(d) for d in re.findall(r"case (\d+): return launch_rows", src)))
    assert compiled == ONE_PASS_WIDTHS
    smoke = ast.parse((_build.CSRC.parents[3] / "chip_smoke.py").read_text())
    held = next(ast.literal_eval(n.value) for n in smoke.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "RMSNORM_ONE_PASS_WIDTHS")
    assert tuple(held) == ONE_PASS_WIDTHS
    for arch in ("ds-paper-100m", "mamba2-1.3b", "granite-34b", "qwen2-72b", "nemotron-4-340b",
                 "mixtral-8x7b", "h2o-danube-3-4b", "internvl2-1b"):
        assert get_arch(arch).d_model in ONE_PASS_WIDTHS, arch


def test_rmsnorm_gradient_gradcheck():
    """The autograd wrapper's analytic backward (dx and dw) against finite
    differences in float64."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((6, 24), generator=gen, dtype=torch.float64, requires_grad=True)
    w = (torch.randn((24,), generator=gen, dtype=torch.float64) + 1.0).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: rms_mod.rmsnorm(a, b, 1e-5), (x, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_gradient_matches_reference(dtype):
    """dx and dw of the model-layout op against ``jax.grad`` through the
    reference's norm (the math of its ``apply_norm``)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) + 1.0).astype(np.float32)
    g = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jx, tx = both(x, dtype)
    jw, tw = both(w, dtype)
    jg, tg = both(g, dtype)

    def jloss(a, b):
        return jnp.sum(jref.rmsnorm_reference(a, b).astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    ops.rmsnorm(tx, tw).backward(tg)
    for a, b in zip((tx.grad, tw.grad), want):
        assert a.dtype == tx.dtype
        np.testing.assert_allclose(f32(a), f32(b), **(tol(dtype) if dtype == "float32" else
                                                     dict(rtol=2e-2, atol=5e-2)))


def test_rmsnorm_wrapper_takes_2d_only():
    with pytest.raises(ValueError, match="rows, d"):
        rms_mod.rmsnorm(torch.zeros((2, 3, 4)), torch.ones(4))


# ------------------------------------------------------------------ registry
def test_oracle_registry_is_total():
    """Every public ``kernels.ops`` entry point has a registered oracle."""
    public = {
        name for name, fn in vars(ops).items()
        if inspect.isfunction(fn) and fn.__module__ == ops.__name__
        and not name.startswith("_")
    }
    assert public == set(ref.ORACLES), (
        f"ORACLES registry drift: ops has {sorted(public)}, "
        f"registry has {sorted(ref.ORACLES)}"
    )


def test_plain_path_never_loads_the_kernel_library(monkeypatch):
    """CPU tensors take the plain versions: the CUDA library is never
    built or loaded for them, and no launch is counted."""
    from repro_torch.kernels import _build

    def boom():
        raise AssertionError("kernel library touched on the CPU path")

    monkeypatch.setattr(_build, "library", boom)
    def counts():
        return (flash_decode.paged_flash_attention_folded.launches, rms_mod.rmsnorm.launches,
                flash_attention.flash_attention_bhsd.launches)

    before = counts()
    case = _paged_case(B=2, T=1, hkv=2, g=2, dk=16, ps=4, P=4, n_pages=8, offsets=[3, 6])
    ops.paged_attention(*(torch.from_numpy(x) for x in case), scale=1 / math.sqrt(16))
    ops.rmsnorm(torch.ones((3, 8)), torch.ones(8))
    q = torch.ones((1, 4, 8, 64))
    ops.flash_attention(q, q, q)
    after = counts()
    assert before == after


def test_build_digest_sees_headers_and_link_flags(monkeypatch, tmp_path):
    """The library's name hashes every ``csrc/*.cu`` and ``*.cuh`` and the
    compile and link flags, so an edited header or flag is never served a
    stale library (no ``nvcc`` needed to check)."""
    from repro_torch.kernels import _build

    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._digest()
    assert _build._digest() == first
    (tmp_path / "b.cuh").write_text("// v2\n")
    second = _build._digest()
    assert second != first
    monkeypatch.setattr(_build, "LINK_FLAGS", [*_build.LINK_FLAGS, "-lcuda"])
    assert _build._digest() not in (first, second)


class _YieldingCounter:
    """A wrapper's counters whose ``launches`` write gives up the GIL
    before it stores: an unguarded ``launches += 1`` from two threads then
    stores a stale count whenever they interleave, as worker threads
    serving on one card can."""

    def __init__(self):
        self._n = 0
        self.launches_by_path = dict.fromkeys(flash_decode.PATHS, 0)

    @property
    def launches(self):
        return self._n

    @launches.setter
    def launches(self, value):
        time.sleep(1e-6)  # gives up the GIL between the read and the store
        self._n = value


def _hammer(fn, n_threads=8):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_launch_counts_are_exact_across_threads():
    slow = _YieldingCounter()
    wrappers = [flash_decode.paged_flash_attention_folded, rms_mod.rmsnorm,
                flash_attention.flash_attention_bhsd, ssd_mod.ssd_chunk]
    saved = [(w.launches, dict(getattr(w, "launches_by_path", {}))) for w in wrappers]
    for w in wrappers:
        w.launches = 0
    try:
        def work(i):
            for j in range(300):
                path = flash_decode.PATHS[(i + j) % len(flash_decode.PATHS)]
                _build.count_launch(slow, path)
                _build.count_launch(flash_decode.paged_flash_attention_folded, path)
                for w in wrappers[1:]:
                    _build.count_launch(w)

        base = dict(flash_decode.paged_flash_attention_folded.launches_by_path)
        _hammer(work)
        assert slow.launches == 8 * 300
        assert sum(slow.launches_by_path.values()) == 8 * 300
        assert slow.launches_by_path == {p: 8 * 100 for p in flash_decode.PATHS}
        for w in wrappers:
            assert w.launches == 8 * 300, w.__name__
        paged = flash_decode.paged_flash_attention_folded.launches_by_path
        assert {p: paged[p] - base[p] for p in paged} == {p: 800 for p in flash_decode.PATHS}
    finally:
        for w, (n, by_path) in zip(wrappers, saved):
            w.launches = n
            if by_path:
                w.launches_by_path = by_path


def test_decode_scratch_grows_safely_across_threads(monkeypatch):
    """Threads asking the decode path's scratch for different sizes at
    once each get a pair at least as large as asked, and the pair kept is
    the largest asked for: none stores a smaller buffer over a larger one."""
    real_empty, real_zeros = torch.empty, torch.zeros

    def yielding(make):
        def alloc(*args, **kwargs):
            time.sleep(1e-5)  # the allocation gives up the GIL
            return make(*args, **kwargs)
        return alloc

    monkeypatch.setattr(torch, "empty", yielding(real_empty))
    monkeypatch.setattr(torch, "zeros", yielding(real_zeros))
    device = torch.device("cpu")
    flash_decode._decode_scratch.pop(device, None)
    rng = np.random.default_rng(4)
    asks = np.sort(rng.integers(1, 4096, (8, 200)), axis=1)  # each thread keeps growing it
    short = []

    def work(i):
        for n in asks[i]:
            ws, counters = flash_decode._decode_buffers(device, int(n) * 16, int(n))
            if ws.numel() < n * 16 or counters.numel() < n:
                short.append(int(n))

    try:
        _hammer(work)
        ws, counters = flash_decode._decode_scratch[device]
    finally:
        flash_decode._decode_scratch.pop(device, None)
    assert not short
    assert ws.numel() == int(asks.max()) * 16 and counters.numel() == int(asks.max())
    assert ws.dtype == torch.float32 and counters.dtype == torch.int32
