"""The encoder-decoder (``whisper-tiny``: an encoder over 1,500 stub audio
frames, a decoder with cross attention to it, LayerNorm, learned
positions instead of RoPE) in the port, plain path on the CPU, against
the reference package on identical numpy inputs.

Held: ``SyntheticLM``'s frames against the reference's at max abs 1e-6;
the configs field for field (full and reduced); reduced whisper's
forward and loss with frames in f32 at 1e-5 and bf16 at 2e-2 (direct
attention and the flash op's plain version); decode with the cross cache
filled from the encoder (the reference's recipe in
``tests/test_arch_smoke.py``) against the reference's decode at 1e-5 in
f32; the dense engine's tokens and every counter against the
reference's, and its paged, fused-prefill and speculation refusals
message for message; the train, eval and serve payloads through both
packages' runtimes from the reference's seed-0 checkpoint; the
full-width tree against ``jax.eval_shape`` through ``params_from_jax``;
the flash op's plain version, non-causal at whisper's lengths, against
the reference's kernel in interpret mode; the cross cache's page view
through ``ops.paged_attention`` against unmasked direct attention; the
routes the card takes.  The reference's LayerNorms start at w 1 and b 0,
which would hide a wrongly bridged bias: the model tests redraw them in
the one tree both packages use."""

import dataclasses
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.launch.serve  # noqa: F401  (registers distributed-serve)
import repro.launch.train  # noqa: F401  (registers distributed-train/eval)
import repro_torch.core as tcore
import repro_torch.launch.serve  # noqa: F401
import repro_torch.launch.train  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels.flash_attention import flash_attention_bhsd as jflash
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.models.layers import qkv_project as jqkv_project
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro.train import checkpoint as jckpt
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention, ops
from repro_torch.kernels.flash_decode import decode_plan, kernel_path
from repro_torch.models import Model, ModelRuntime
from repro_torch.models import weights
from repro_torch.models.layers import attention_scores, repeat_kv
from repro_torch.models.transformer import cross_page_view
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.tree import tree_leaves, tree_map_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

ARCH = "whisper-tiny"
NORM_STD = 0.1  # the redrawn LayerNorm w (about 1) and b (about 0)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def logit_tol(dtype: str, want: np.ndarray) -> dict:
    """f32 at 1e-5; bf16 at 2e-2 of the logits' scale (their largest
    magnitude), as ``test_torch_vlm.py`` holds them: the two packages' bf16
    matmuls round the hidden state apart by a few bf16 ulps."""
    if dtype == "float32":
        return TOL[dtype]
    return dict(rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))


# ------------------------------------------------------------- data
@pytest.mark.parametrize("step,dp_rank,n_dp", [(0, 0, 1), (3, 1, 2)])
def test_synthetic_frames_match_reference(step, dp_rank, n_dp):
    jcfg, cfg = jreduced(jget_arch(ARCH)), reduced(get_arch(ARCH))
    want = JSyntheticLM(jcfg, JDataConfig(seq_len=24, global_batch=4, seed=3)).batch(
        step, dp_rank=dp_rank, n_dp=n_dp)
    got = SyntheticLM(cfg, DataConfig(seq_len=24, global_batch=4, seed=3), device="cpu").batch(
        step, dp_rank=dp_rank, n_dp=n_dp)
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    assert got["frames"].shape == (4 // n_dp, cfg.encoder_seq, cfg.d_model)
    assert got["frames"].dtype == torch.float32
    np.testing.assert_allclose(got["frames"].numpy(), np.asarray(want["frames"]), rtol=0,
                               atol=1e-6)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_full_width_frames_match_reference():
    cfg = get_arch(ARCH)
    got = SyntheticLM(cfg, DataConfig(seq_len=8, global_batch=1), device="cpu").batch(0)
    want = JSyntheticLM(jget_arch(ARCH), JDataConfig(seq_len=8, global_batch=1)).batch(0)
    assert got["frames"].shape == (1, 1500, 384) and got["tokens"].shape == (1, 8)
    np.testing.assert_allclose(got["frames"].numpy(), np.asarray(want["frames"]), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------- configs
def test_config_matches_reference():
    assert dataclasses.asdict(get_arch(ARCH)) == dataclasses.asdict(jget_arch(ARCH))
    assert (dataclasses.asdict(reduced(get_arch(ARCH)))
            == dataclasses.asdict(jreduced(jget_arch(ARCH))))
    cfg = get_arch(ARCH)
    assert (cfg.family, cfg.is_encoder_decoder, cfg.encoder_seq, cfg.norm) == (
        "audio", True, 1500, "layernorm")
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.resolved_head_dim) == (4, 4, 64)
    small = reduced(cfg)
    assert (small.n_encoder_layers, small.encoder_seq, small.max_position_embeddings) == (
        2, 32, 512)


# ------------------------------------------------------------- the model
def with_norms(jp, seed: int = 9):
    """The reference's tree with every LayerNorm's ``w`` and ``b`` redrawn
    around 1 and 0."""
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = path[-1].key
        if name not in ("w", "b"):
            return a
        draw = rng.standard_normal(a.shape).astype(np.float32) * NORM_STD
        return jnp.asarray(draw + (1.0 if name == "w" else 0.0), a.dtype)

    return jax.tree_util.tree_map_with_path(redraw, jp)


def pair(**runtime):
    """(jax model, jax params, port model, port params) on one weight set."""
    jm = JModel(jreduced(jget_arch(ARCH)), JRuntime(**runtime))
    jp = with_norms(jm.init(jax.random.PRNGKey(0)))
    m = Model(reduced(get_arch(ARCH)))
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return pair(attn_impl="direct")


def frames_for(cfg, b: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("impl", ["direct", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_with_frames_match_reference(models, dtype, impl):
    """The encoder over the frames, the decoder's self and cross attention:
    the logits ``(B, S, Vp)`` and the loss."""
    jm, jp, cfg = models[0], models[1], models[2].cfg
    jdt, tdt = DTYPES[dtype]
    jm = JModel(jm.cfg, JRuntime(dtype=jdt, attn_impl="direct"))
    jp = jax.tree.map(lambda a: a.astype(jdt), jp)
    m = Model(cfg, ModelRuntime(dtype=tdt, attn_impl=impl))
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp),
                         device="cpu", dtype=tdt)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    frames = frames_for(cfg, 2)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks), frames=jnp.asarray(frames)), np.float32)
    got = m.forward(tp, torch.from_numpy(toks), frames=torch.from_numpy(frames))
    assert got.shape == (2, 40, cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **logit_tol(dtype, want))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}
    jl, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet = m.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL[dtype])
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == 2 * 39


def test_frames_and_norm_bias_move_the_logits(models):
    """The fault controls: other frames give other logits, and so does a
    LayerNorm bias, so the forward test sees both."""
    _, _, m, p = models
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 16)))
    a, b = (torch.from_numpy(frames_for(m.cfg, 1, seed)) for seed in (5, 6))
    la, lb = (m.forward(p, toks, frames=x) for x in (a, b))
    assert float((la - lb).abs().max()) > 1e-2
    moved = {**p, "encoder": {**p["encoder"], "ln_f": {"w": p["encoder"]["ln_f"]["w"],
                                                       "b": p["encoder"]["ln_f"]["b"] + 0.5}}}
    assert float((m.forward(moved, toks, frames=a) - la).abs().max()) > 1e-2


def fill_cross(model, params, cache, frames, *, jax_side: bool):
    """The cross cache filled from the encoder as ``tests/test_arch_smoke.py``
    fills it: ``_encode``, then each layer's K and V projections."""
    cfg = model.cfg
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    enc = model._encode(params, frames)
    if jax_side:
        kv = [jqkv_project(jax.tree.map(lambda a, i=i: a[i], params["cross"])["attn"], enc,
                           *heads)[1:] for i in range(cfg.n_layers)]
        cache["cross_k"] = jnp.stack([k for k, _ in kv])
        cache["cross_v"] = jnp.stack([v for _, v in kv])
        return cache
    from repro_torch.models.layers import qkv_project

    for i, cp in enumerate(params["cross"]):
        _, k, v = qkv_project(cp["attn"], enc, *heads)
        cache["cross_k"][i].copy_(k)
        cache["cross_v"][i].copy_(v)
    return cache


def test_decode_with_cross_cache_matches_reference(models):
    """f32: token-by-token decode over a cross cache filled from the
    encoder, each step's logits against the reference's decode at 1e-5 and
    the port's own forward at 1e-4."""
    jm, jp, m, p = models
    cfg, b, s = m.cfg, 2, 16
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (b, s))
    frames = frames_for(cfg, b, seed=8)
    jcache = fill_cross(jm, jp, jm.init_cache(b, s), jnp.asarray(frames), jax_side=True)
    cache = fill_cross(m, p, m.init_cache(b, s, device="cpu"), torch.from_numpy(frames),
                       jax_side=False)
    assert cache["cross_k"].shape == (cfg.n_layers, b, cfg.encoder_seq, cfg.n_kv_heads,
                                      cfg.resolved_head_dim)
    forward = m.forward(p, torch.from_numpy(toks), frames=torch.from_numpy(frames))
    step = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(s):
            want, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                jnp.full((b,), t, jnp.int32))
            got, cache = m.decode_step(p, cache, torch.from_numpy(toks[:, t:t + 1]),
                                       torch.full((b,), t))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got[:, 0].numpy(), forward[:, t].detach().numpy(),
                                       rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- kernels and routes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", [(1500, 1500), (448, 1500)])
def test_flash_plain_non_causal_at_whisper_lengths(sq, skv, dtype):
    """The flash op's plain version (the CPU's route), non-causal, at the
    encoder's 1,500 frames and cross attention's 448 x 1,500 (BH 2),
    against the reference's kernel in interpret mode at blocks that divide
    the lengths (the blocks the model passes)."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 64)).astype(np.float32) for _ in "kv")
    got = flash_attention.flash_attention_bhsd(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), causal=False, block_q=sq,
        block_k=skv)
    want = jflash(*(jnp.asarray(x, jd) for x in (q, k, v)), causal=False, block_q=sq,
                  block_k=skv, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **dict(TOL, float32=dict(rtol=2e-5, atol=2e-5))[dtype])


def test_route_takes_the_kernel_at_whisper_shapes():
    """On the card without a gradient the encoder (non-causal, 1,500),
    cross attention (non-causal) and the decoder (causal, 448) take the
    flash kernel; the CPU and a gradient keep the reference's rule; the
    wrapper's own block check still refuses 1,500 at its default blocks."""
    rt, hd = ModelRuntime(), get_arch(ARCH).resolved_head_dim
    assert rt.resolve_attn(1500, device="cuda", head_dim=hd, causal=False) == "kernel"
    assert rt.resolve_attn(448, device="cuda", head_dim=hd, causal=False) == "kernel"
    assert rt.resolve_attn(448, device="cuda", head_dim=hd) == "kernel"
    assert rt.resolve_attn(1500, device="cuda", head_dim=hd) == "direct"  # causal: blocks
    assert rt.resolve_attn(1500, device="cuda", grad=True, head_dim=hd, causal=False) == "direct"
    assert rt.resolve_attn(1500, device="cpu", head_dim=hd, causal=False) == "direct"
    assert not flash_attention.supports(1500, 16, causal=False)  # no instantiation
    q = torch.zeros((1, 1500, 64))
    with pytest.raises(ValueError, match="must divide blocks"):
        flash_attention.flash_attention_bhsd(q, q, q, causal=False)


@pytest.mark.parametrize("b,n_keys,hkv,g,hd,ps", [(3, 32, 2, 2, 16, 16),
                                                  (2, 1500, 6, 1, 64, 20)])
def test_cross_page_view_matches_unmasked_attention(b, n_keys, hkv, g, hd, ps):
    """The cross cache read as pages through ``ops.paged_attention``'s
    plain version against direct attention without a mask (the
    reference's decode block), f32 at 1e-5: reduced whisper's G 2 over 32
    keys and full width's G 1 over 1,500."""
    rng = np.random.default_rng(n_keys)
    q = torch.from_numpy(rng.standard_normal((b, 1, hkv * g, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, n_keys, hkv, hd)).astype(np.float32))
            for _ in "kv")
    got_ps, table, offsets = cross_page_view(b, n_keys, torch.device("cpu"))
    assert got_ps == ps and table.shape == (b, n_keys // ps) and table.dtype == torch.int32
    assert offsets.tolist() == [n_keys - 1] * b
    pool = (b * n_keys // ps, ps, hkv, hd)
    got = ops.paged_attention(q, k.view(pool), v.view(pool), table, offsets)
    want = attention_scores(q, repeat_kv(k, hkv * g), repeat_kv(v, hkv * g), causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert cross_page_view(b, n_keys, torch.device("cpu"))[1] is table  # built once a shape


@pytest.mark.parametrize("dtype,plan", [(torch.bfloat16, (3, 5)), (torch.float32, (4, 3))])
def test_cross_cache_decode_plan(dtype, plan):
    """Full width's decode cross attention (B 16, Hkv 6, G 1, dk 64, 75
    pages of 20) takes the split-KV decode path; its plan on a 132-SM
    card: (splits, round pages)."""
    cfg = get_arch(ARCH)
    ps, table, _ = cross_page_view(16, cfg.encoder_seq, torch.device("cpu"))
    hd = cfg.resolved_head_dim
    assert kernel_path(dtype, cfg.n_heads // cfg.n_kv_heads, hd, hd) == "decode"
    item = torch.tensor([], dtype=dtype).element_size()
    assert decode_plan(16, cfg.n_kv_heads, table.shape[1], ps, hd, hd, item, 132) == plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_width_tree_matches_reference(dtype, monkeypatch):
    """whisper-tiny whole: the encoder's layers, its final norm and frame
    positions, the decoder's cross attention (stacked in the reference), the
    learned positions, LayerNorm biases: every leaf's shape through
    ``params_from_jax``, the parameter count against ``jax.eval_shape``."""
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
    assert len(own["cross"]) == 4 and len(own["encoder"]["layers"]) == 4
    assert own["pos"].shape == (32768, 384) and own["encoder"]["pos"].shape == (1500, 384)
    assert sum(t.numel() for t in tree_leaves(own)) == want == 50_138_112


def test_bridge_round_trips_the_stacks(models):
    """``params_to_jax`` restacks ``cross`` and ``encoder.layers`` as the
    reference holds them, leaf for leaf."""
    _, jp, _, p = models
    back = weights.params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------------------- serving
COUNTERS = (
    "dispatches", "prefill_dispatches", "decode_dispatches", "steps_executed",
    "tokens_emitted", "prompt_tokens_ingested", "prefix_hit_tokens", "preemptions",
    "tokens_discarded", "peak_pages", "page_allocs", "pages_in_use", "peak_cache_bytes",
)
BATCH = [("a", [1, 2, 3, 4, 5, 6, 7], 5, 0.0), ("b", [9, 8], 6, 0.0), ("c", [42], 4, 0.7),
         ("d", [5, 4, 3, 2, 1, 17, 23, 31, 44], 5, 0.0), ("e", [1, 2, 3, 4, 5, 6, 9], 3, 0.0)]
DENSE = dict(max_batch=3, max_len=32, prefill_chunk=4, cache_mode="dense", rng_seed=3)


def requests(cls, batch):
    return [cls(uid=u, prompt=list(p), max_new_tokens=n, temperature=t) for u, p, n, t in batch]


def test_dense_engine_matches_reference(models):
    """The dense engine, every prompt ingested one token a decode dispatch
    (an encoder-decoder takes no fused prefill), the cross cache as
    ``init_cache`` makes it and admissions zero it: outputs (a temperature
    row among them) and every counter equal."""
    jm, jp, m, p = models
    jeng = JEngine(JModel(jm.cfg), jp, **DENSE)
    jeng.submit(requests(JRequest, BATCH))
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    eng = ServeEngine(m, p, device="cpu", **DENSE)
    assert set(eng.cache) == {"k", "v", "cross_k", "cross_v"}
    eng.cache["cross_k"].fill_(1.0)  # an admission zeroes its row, as the reference's does
    eng.submit(requests(Request, BATCH))
    eng.run_to_completion()
    assert {r.uid: r.output for r in eng.finished} == want
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.prefill_dispatches == 0 and eng._use_prefill is jeng._use_prefill is False
    assert not m.supports_fused_prefill and not m.supports_paged_cache


REFUSALS = {
    "paged": dict(cache_mode="paged", page_size=8),
    "prefill_role": dict(worker_role="prefill"),
    "speculative_ngram": dict(speculative="ngram"),
    "speculative_draft": dict(speculative="draft"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_engine_refusals_match_reference(models, name):
    jm, jp, m, p = models
    kw = dict(max_batch=2, max_len=32, prefill_chunk=4, **REFUSALS[name])
    with pytest.raises(ValueError) as want:
        JEngine(JModel(jm.cfg), jp, **kw)
    with pytest.raises(ValueError) as got:
        ServeEngine(m, p, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_model_refusals_match_reference(models):
    """The paged cache and the fused chunk-extend refuse, message for
    message."""
    jm, jp, m, p = models
    with pytest.raises(ValueError) as want:
        jm.init_cache(2, 32, paged=True)
    with pytest.raises(ValueError) as got:
        m.init_cache(2, 32, paged=True, device="cpu")
    assert str(got.value) == str(want.value)
    args = (np.ones((2, 4), np.int64), np.zeros(2, np.int32), np.full(2, 4, np.int32))
    with pytest.raises(NotImplementedError) as want:
        jm.prefill_chunk(jp, jm.init_cache(2, 32), *map(jnp.asarray, args))
    with pytest.raises(NotImplementedError) as got:
        m.prefill_chunk(p, m.init_cache(2, 32, device="cpu"), *map(torch.from_numpy, args))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- the payloads
JOB = {"arch": ARCH, "arch_overrides": "reduced", "device": "cpu"}
TRAIN = {**JOB, "seq_len": 16, "global_batch": 2, "lr": 1e-3, "warmup_steps": 1,
         "ckpt_every": 1}
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42], [5, 4, 3, 2, 1, 17, 23, 31, 44]]
SERVE = {**JOB, "max_new_tokens": 4, "max_len": 40, "max_batch": 2, "prefill_chunk": 4,
         "cache_mode": "dense"}


def run_ds(core, root, payload, shared, groups):
    clk = core.VirtualClock()
    cfg = core.DSConfig(app_name="WHISPER", payload=payload, cluster_machines=1,
                        tasks_per_machine=1, machine_type=["sim.large"], machine_price=1.0,
                        sqs_message_visibility=240.0, max_receive_count=8,
                        check_if_done=False)
    rt = core.DSRuntime(cfg, store_root=str(root), clock=clk)
    rt.setup()
    rt.submit_job(core.JobFile(shared=dict(shared), groups=[dict(g) for g in groups]))
    rt.start_cluster(core.FleetFile(startup_seconds=0.0))
    summary = core.SimRunner(rt, tick_seconds=30.0).run(max_ticks=400)
    assert summary.jobs_failed == 0 and summary.jobs_done == len(groups), summary


def test_train_eval_and_serve_payloads_match_reference(tmp_path):
    """From the reference's seed-0 checkpoint: two train spans of one step
    (frames in every batch), an eval shard and a static dense serve job,
    each through both packages' runtimes on the CPU."""
    seed = tmp_path / "seed"
    jm = JModel(jreduced(jget_arch(ARCH)))
    jckpt.save_checkpoint(jcore.ObjectStore(str(seed)), "t", 0, jm.init(jax.random.PRNGKey(0)))
    stores = {}
    for name, core in (("ref", jcore), ("port", tcore)):
        root = tmp_path / name
        shutil.copytree(seed / "ckpt", root / "ckpt")
        jf = core.step_span_job_file(arch=ARCH, total_steps=2, span=1, run="t",
                                     shared=dict(TRAIN, total_steps=2))
        run_ds(core, root, "distributed-train", jf.shared, jf.groups)
        run_ds(core, root, "distributed-eval", {**TRAIN, "run": "t", "n_batches": 2},
               [{"shard": 0}])
        run_ds(core, root, "distributed-serve", {**SERVE, "run": "t"},
               [{"prompts": PROMPTS[:2], "output_prefix": "serve/b0"},
                {"prompts": PROMPTS[2:], "output_prefix": "serve/b1"}])
        stores[name] = jcore.ObjectStore(str(root))
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    for step in (1, 2):
        want, wmeta = jckpt.restore_checkpoint(stores["ref"], "t", step, like)
        got, gmeta = jckpt.restore_checkpoint(stores["port"], "t", step, like)
        np.testing.assert_allclose(gmeta["loss"], wmeta["loss"], rtol=1e-5)
        # as test_torch_vlm.py: AdamW's m / sqrt(v) turns gradients that
        # agree to ~1e-6 of each leaf's largest into up to a few % of a
        # step (lr 1e-3) where an element is near eps
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-4)
    key = "runs/t/eval/shard0/METRICS.json"
    got, want = stores["port"].get_json(key), stores["ref"].get_json(key)
    assert got["ckpt_step"] == want["ckpt_step"] == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for b in (0, 1):
        key = f"serve/b{b}/RESULTS.json"
        assert stores["port"].get_json(key) == stores["ref"].get_json(key), key


def test_eval_runner_sees_the_frames(tmp_path):
    """The eval runner's loss is the loss over batches with frames: it
    equals ``Model.loss`` on ``SyntheticLM``'s batch, and differs from the
    loss over other frames."""
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch.train import build_model, run_eval
    from repro_torch.train.checkpoint import save_state

    job = {**TRAIN, "run": "e", "n_batches": 1, "data_seed": 5}
    model = build_model(job)
    params = model.init(0, device="cpu")
    store = ObjectStore(str(tmp_path))
    save_state(store, "e", 1, params)
    out = run_eval(job, store, lambda **_: None, device="cpu")
    batch = SyntheticLM(model.cfg, DataConfig(seq_len=16, global_batch=2, seed=5),
                        device="cpu").batch(0)
    with torch.no_grad():
        want = float(model.loss(params, batch)[0])
        other = float(model.loss(params, {**batch, "frames": batch["frames"].flip(1)})[0])
    assert out["loss"] == pytest.approx(want, rel=1e-6)
    assert math.isfinite(want) and abs(other - want) > 1e-4
