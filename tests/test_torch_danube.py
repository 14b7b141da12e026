"""``h2o-danube-3-4b`` (GQA 32 over 8 heads of width 120, a 4096-token
sliding window) in the port, plain path on the CPU, against the reference
package on identical numpy inputs at ``reduced()`` size (head width 16,
window 32, so the dense cache rolls over 128 slots).

Held: the configs field for field (full and reduced); the full-sequence
forward, loss and prefill step past the window (direct, chunked and the
flash op's plain version) in f32 at 1e-5 and bf16 at 2e-2 of the logits'
scale; decode one token at a time across the rolling cache's wrap against
the reference's decode and against one windowed forward; the dense
engine, rolling and not, tokens and every counter equal; the prefill-role
and speculative refusals on the rolling cache message for message; the
flash op's plain version at head width 120, causal and windowed, against
the reference's flash kernel in interpret mode; the attention route of
danube's eval on the card (the flash kernel at 120); the full-width tree
against ``jax.eval_shape`` through ``params_from_jax``; ``Model.draw``'s
tree for both new configs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro.train.steps import make_prefill_step as jmake_prefill_step
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import Model, ModelRuntime, weights
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.train.steps import make_prefill_step
from repro_torch.tree import tree_leaves, tree_map_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

ARCH = "h2o-danube-3-4b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def logit_tol(dtype: str, want: np.ndarray) -> dict:
    """f32 at 1e-5; bf16 at 2e-2 of the logits' scale (their largest
    magnitude): the packages' bf16 matmuls round the hidden state apart by
    a few bf16 ulps, ~0.055 at logits of ~4 for every reduced dense model
    alike, which a plain atol of 2e-2 would fail at a logit near zero."""
    if dtype == "float32":
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))


def test_config_matches_reference():
    assert dataclasses.asdict(get_arch(ARCH)) == dataclasses.asdict(jget_arch(ARCH))
    assert (dataclasses.asdict(reduced(get_arch(ARCH)))
            == dataclasses.asdict(jreduced(jget_arch(ARCH))))
    cfg = get_arch(ARCH)
    assert (cfg.resolved_head_dim, cfg.sliding_window, cfg.n_heads // cfg.n_kv_heads,
            cfg.qkv_bias) == (120, 4096, 4, False)
    assert reduced(cfg).sliding_window == 32


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params) on one weight set."""
    jm = JModel(jreduced(jget_arch(ARCH)), JRuntime(attn_impl="direct"))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, Model(reduced(get_arch(ARCH))), params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("impl", ["direct", "chunked", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_prefill_match_reference(models, dtype, impl):
    """96 tokens, three times the reduced window: logits, loss and the
    prefill step."""
    jm, jp, m, _ = models
    jdt, tdt = DTYPES[dtype]
    jm = JModel(jm.cfg, JRuntime(dtype=jdt, attn_impl="direct"))
    jp = jax.tree.map(lambda a: a.astype(jdt), jp)
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp),
                         device="cpu", dtype=tdt)
    m = Model(m.cfg, ModelRuntime(dtype=tdt, attn_impl=impl, attn_chunk=32))
    toks = np.random.default_rng(3).integers(0, m.cfg.vocab_size, (2, 96))
    want = np.asarray(jm.forward(jp, jnp.asarray(toks)), np.float32)
    got = m.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **logit_tol(dtype, want))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = m.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5 if dtype == "float32" else 2e-2)
    want = np.asarray(jmake_prefill_step(jm)(jp, jnp.asarray(toks)), np.float32)
    np.testing.assert_allclose(make_prefill_step(m)(tp, torch.from_numpy(toks)).numpy(), want,
                               **logit_tol(dtype, want))


def test_the_window_moves_the_logits(models):
    """The fault control: without the window the logits past position 32
    differ, so the forward test sees the window."""
    _, _, m, p = models
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 64)))
    bare = Model(dataclasses.replace(m.cfg, sliding_window=0))
    a, b = m.forward(p, toks), bare.forward(p, toks)
    assert torch.allclose(a[:, :32], b[:, :32], atol=1e-6)
    assert float((a[:, 32:] - b[:, 32:]).abs().max()) > 1e-3


def test_decode_across_the_rolling_cache_wrap(models):
    """Two rows decoded one position at a time through 144 positions of the
    128-slot rolling cache (window 32): every step's logits against the
    reference's decode at 1e-5 and against one windowed forward of the
    same tokens at 1e-4, the cache against the reference's at the end."""
    jm, jp, m, p = models
    n = 144
    toks = np.random.default_rng(5).integers(1, 256, (2, n)).astype(np.int32)
    jc = jm.init_cache(2, n)
    tc = m.init_cache(2, n, device="cpu")
    assert tc["k"].shape[2] == 128 < n and jc["k"].shape == tc["k"].shape
    decoded, jdecode = [], jax.jit(jm.decode_step)
    for pos in range(n):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, pos:pos + 1]),
                         jnp.full((2,), pos, jnp.int32))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(toks[:, pos:pos + 1]).long(),
                               torch.full((2,), pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        decoded.append(tl[:, 0])
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=1e-5, atol=1e-5)
    full = Model(m.cfg, ModelRuntime(attn_impl="chunked", attn_chunk=48)).forward(
        p, torch.from_numpy(toks).long())
    np.testing.assert_allclose(torch.stack(decoded, 1).numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------- the engine
COUNTERS = (
    "dispatches", "prefill_dispatches", "decode_dispatches", "steps_executed",
    "tokens_emitted", "prompt_tokens_ingested", "preemptions", "tokens_discarded",
    "peak_cache_bytes",
)
_rng = np.random.default_rng(12)
# r0 runs to position 137, past the 128 rolling slots
ROLLING = [("r0", _rng.integers(1, 256, 124).tolist(), 14, 0.0),
           ("r1", _rng.integers(1, 256, 21).tolist(), 8, 0.7),
           ("r2", [5, 4, 3, 2, 1], 6, 0.0), ("r3", [42], 5, 0.0)]
SHORT = [("a", list(range(1, 60)), 6, 0.0), ("b", list(range(100, 141)), 8, 0.0),
         ("c", [9, 8], 5, 0.7)]
ENGINES = {  # (requests, knobs): 160 slots roll at 128; 96 do not
    "rolling": (ROLLING, dict(max_batch=3, max_len=160, prefill_chunk=16, rng_seed=4)),
    "rolling_grouped": (ROLLING, dict(max_batch=3, max_len=160, prefill_chunk=16,
                                      dispatch_mode="grouped", rng_seed=4)),
    "not_rolling": (SHORT, dict(max_batch=2, max_len=96, prefill_chunk=16, rng_seed=4)),
}


def requests(cls, batch):
    return [cls(uid=u, prompt=list(p), max_new_tokens=k, temperature=t) for u, p, k, t in batch]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_dense_engine_matches_reference(models, engine):
    """On the rolling cache every prompt is ingested a token a decode
    dispatch; on a cache that does not roll, through the fused prefill
    under the window: outputs (temperature rows among them) and every
    counter equal."""
    jm, jp, m, p = models
    batch, kw = ENGINES[engine]
    jeng = JEngine(JModel(jm.cfg), jp, **kw)
    jeng.submit(requests(JRequest, batch))
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    eng = ServeEngine(m, p, device="cpu", **kw)
    eng.submit(requests(Request, batch))
    eng.run_to_completion()
    assert {r.uid: r.output for r in eng.finished} == want
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    rolling = engine.startswith("rolling")
    assert eng.cache_mode == "dense" and eng.cache_mgr.cache_is_rolling() == rolling
    assert eng._use_prefill == jeng._use_prefill == (not rolling)
    if rolling:
        r0 = next(r for r in eng.finished if r.uid == "r0")
        assert len(r0.prompt) + len(r0.output) > 128  # the cache wrapped


REFUSALS = {
    "prefill_role": dict(worker_role="prefill"),
    "speculative": dict(speculative="ngram"),
    "paged": dict(cache_mode="paged", page_size=8),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_rolling_cache_refusals_match_reference(models, name):
    jm, jp, m, p = models
    kw = dict(max_batch=2, max_len=160, prefill_chunk=4, **REFUSALS[name])
    with pytest.raises(ValueError) as want:
        JEngine(JModel(jm.cfg), jp, **kw)
    with pytest.raises(ValueError) as got:
        ServeEngine(m, p, device="cpu", **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- flash at 120
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_plain_at_head_width_120_matches_reference_kernel(dtype, causal, window):
    """The flash op (its plain version on the CPU) at danube's head width
    against the reference's Pallas kernel in interpret mode, in the model
    layout with blocks of 128 over 256 positions: 2e-5 in f32, 2e-2 in
    bf16; the scale is 1/sqrt(120)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7 + window)
    q, k, v = (rng.standard_normal((1, 256, 2, 120)).astype(np.float32) for _ in range(3))
    want = jops.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
                                sliding_window=window, block_q=128, block_k=128,
                                interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal,
                              sliding_window=window, block_q=128, block_k=128)
    assert got.dtype == tdt and got.shape == q.shape
    t = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=t, atol=t)


def test_danube_eval_on_the_card_takes_the_flash_kernel():
    """At head width 120 the full-sequence attention on a CUDA device with
    no gradient resolves to the kernel (decided without a card); under a
    gradient or on the CPU the reference's rule stands."""
    cfg = get_arch(ARCH)
    rt, hd = ModelRuntime(), cfg.resolved_head_dim
    assert 120 in flash_attention.HEAD_DIMS and flash_attention.supports(8192, hd)
    assert rt.resolve_attn(8192, device="cuda", head_dim=hd) == "kernel"
    assert rt.resolve_attn(8192, device="cuda", grad=True, head_dim=hd) == "chunked"
    assert rt.resolve_attn(8192, device="cpu", head_dim=hd) == "chunked"
    assert not flash_attention.supports(8192, 112)  # a width with no instantiation


# ------------------------------------------------------------- trees
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_width_tree_matches_reference(dtype, monkeypatch):
    """h2o-danube-3-4b whole: ``jax.eval_shape`` of the reference's init,
    that tree through ``params_from_jax`` (its leaves made as ``meta``
    tensors) and the port's ``abstract_params``, leaf for leaf; nothing
    allocated."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    like = jax.eval_shape(JModel(jget_arch(ARCH), JRuntime(dtype=jdt)).init,
                          jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(like))
    monkeypatch.setattr(weights, "_tensor", lambda a, device, dt: torch.empty(
        a.shape, dtype=dt, device="meta"))
    bridged = params_from_jax(like, device="cpu", dtype=dtype)
    own = Model(get_arch(ARCH), ModelRuntime(dtype=dtype)).abstract_params()
    assert tree_map_with_path(lambda p, t: (p, tuple(t.shape), t.dtype), bridged) == (
        tree_map_with_path(lambda p, t: (p, tuple(t.shape), t.dtype), own))
    assert sum(t.numel() for t in tree_leaves(own)) == want == 3_967_737_600
    assert own["layers"][0]["attn"]["wq"].shape == (3840, 32 * 120)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", [ARCH, "internvl2-1b"])
def test_draw_builds_init_tree(arch, dtype):
    """``Model.draw`` (the card's draw, run here on a CPU generator) puts
    every leaf where ``init`` does, with its shape and dtype."""
    m = Model(reduced(get_arch(arch)), ModelRuntime(dtype=dtype))
    drawn = m.draw(torch.Generator("cpu").manual_seed(0))
    own = m.init(0, device="cpu")
    sig = lambda tree: tree_map_with_path(  # noqa: E731
        lambda path, t: (path, tuple(t.shape), t.dtype), tree)
    assert sig(drawn) == sig(own)
