"""The VLM backbone (``internvl2-1b``: 14 query heads over 2 KV heads,
QKV bias, RoPE at theta 1e6, 256 stub vision tokens ahead of the text) in
the port, plain path on the CPU, against the reference package on
identical numpy inputs.

Held: ``prng.normal`` against ``jax.random.normal`` at max abs 1e-6 (the
draw the patches come from); ``SyntheticLM``'s patches against the
reference's; the configs field for field (full and reduced); reduced
internvl's forward and loss with patches in f32 at 1e-5 and bf16 at 2e-2
(direct attention and the flash op's plain version); the paged and dense
engines on reduced internvl (prompts ingested a token a decode dispatch):
tokens and every counter equal to the reference's; the fused-prefill and
speculation refusals message for message; the train, eval and serve
payloads through both packages' runtimes from the reference's seed-0
checkpoint; the full-width tree against ``jax.eval_shape`` through
``params_from_jax``; the paged kernel's path at the 7-row decode fold.
The reference draws ``bq``/``bk``/``bv`` as zeros, which would hide the
bias: the model tests redraw them non-zero in the one tree both packages
use."""

import dataclasses
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
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro.train import checkpoint as jckpt
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro_torch import prng
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_decode import kernel_path
from repro_torch.models import Model, ModelRuntime
from repro_torch.models import weights
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.tree import tree_leaves, tree_map_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

ARCH = "internvl2-1b"
BIAS_STD = 0.5  # q, k and v are ~N(0, 1) at init: a bias of this size moves every logit
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def logit_tol(dtype: str, want: np.ndarray) -> dict:
    """f32 at 1e-5; bf16 at 2e-2 of the logits' scale (their largest
    magnitude): the two packages' bf16 matmuls round the hidden state
    apart by a few bf16 ulps, ~0.055 at logits of ~4.5 after two layers
    for every reduced dense model alike (ds-paper-100m included), which a
    plain atol of 2e-2 would fail at a logit near zero."""
    if dtype == "float32":
        return TOL[dtype]
    return dict(rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------------------------- prng.normal
@pytest.mark.parametrize("seed,shape", [(0, ()), (1, (7,)), (2, (3, 5, 11)), (3, (2, 8, 64)),
                                        (42, (8, 256, 896))])
def test_normal_matches_jax_random_normal(seed, shape):
    """float32 draws at max abs 1e-6, tails included (|x| past 5 at the
    largest shape); ``torch.erfinv`` would miss by ~2e-5 there."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    got = prng.normal(prng.PRNGKey(seed, device="cpu"), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_normal_takes_batched_and_folded_keys():
    key = jax.random.fold_in(jax.random.PRNGKey(5), 8)
    want = np.asarray(jax.random.normal(key, (4, 16), jnp.float32))
    got = prng.normal(prng.fold_in(prng.PRNGKey(5, device="cpu"), 8), (4, 16))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, float(np.nextafter(np.float32(-1), np.float32(0)))])
    got = prng.erfinv(x)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert list(got[:3]) == list(want[:3]) == [-float("inf"), float("inf"), 0.0]
    np.testing.assert_allclose(got.numpy()[3:], want[3:], rtol=1e-6)


# ------------------------------------------------------------- data
@pytest.mark.parametrize("step,dp_rank,n_dp", [(0, 0, 1), (3, 1, 2)])
def test_synthetic_patches_match_reference(step, dp_rank, n_dp):
    jcfg, cfg = jreduced(jget_arch(ARCH)), reduced(get_arch(ARCH))
    want = JSyntheticLM(jcfg, JDataConfig(seq_len=24, global_batch=4, seed=3)).batch(
        step, dp_rank=dp_rank, n_dp=n_dp)
    got = SyntheticLM(cfg, DataConfig(seq_len=24, global_batch=4, seed=3), device="cpu").batch(
        step, dp_rank=dp_rank, n_dp=n_dp)
    assert sorted(got) == sorted(want) == ["labels", "patches", "tokens"]
    assert got["patches"].shape == (4 // n_dp, cfg.n_vision_tokens, cfg.d_model)
    assert got["patches"].dtype == torch.float32
    np.testing.assert_allclose(got["patches"].numpy(), np.asarray(want["patches"]), rtol=0,
                               atol=1e-6)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_full_width_patches_shape():
    cfg = get_arch(ARCH)
    b = SyntheticLM(cfg, DataConfig(seq_len=8, global_batch=2), device="cpu").batch(0)
    assert b["patches"].shape == (2, 256, 896) and b["tokens"].shape == (2, 8)


# ------------------------------------------------------------- configs
def test_config_matches_reference():
    assert dataclasses.asdict(get_arch(ARCH)) == dataclasses.asdict(jget_arch(ARCH))
    assert (dataclasses.asdict(reduced(get_arch(ARCH)))
            == dataclasses.asdict(jreduced(jget_arch(ARCH))))
    cfg = get_arch(ARCH)
    assert (cfg.family, cfg.n_vision_tokens, cfg.qkv_bias, cfg.rope_theta) == (
        "vlm", 256, True, 1_000_000.0)
    assert cfg.n_heads // cfg.n_kv_heads == 7 and cfg.resolved_head_dim == 64
    assert reduced(cfg).n_vision_tokens == 8


# ------------------------------------------------------------- the model
def with_bias(jp, seed: int = 9):
    """The reference's tree with ``bq``/``bk``/``bv`` redrawn non-zero."""
    attn, rng = jp["layers"]["attn"], np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        b = attn[name]
        attn[name] = jnp.asarray(rng.standard_normal(b.shape).astype(np.float32) * BIAS_STD,
                                 b.dtype)
    return jp


def pair(**runtime):
    """(jax model, jax params, port model, port params) on one weight set."""
    jm = JModel(jreduced(jget_arch(ARCH)), JRuntime(**runtime))
    jp = with_bias(jm.init(jax.random.PRNGKey(0)))
    m = Model(reduced(get_arch(ARCH)))
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return pair(attn_impl="direct")


@pytest.mark.parametrize("impl", ["direct", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_with_patches_match_reference(models, dtype, impl):
    """Patches ahead of the tokens, positions over the whole stream: the
    logits ``(B, 8 + S, Vp)`` and the loss over the text positions."""
    jm, jp, cfg, p = models[0], models[1], models[2].cfg, models[3]
    jdt, tdt = DTYPES[dtype]
    jm = JModel(jm.cfg, JRuntime(dtype=jdt, attn_impl="direct"))
    jp = jax.tree.map(lambda a: a.astype(jdt) if a.dtype == jnp.float32 else a, jp)
    m = Model(cfg, ModelRuntime(dtype=tdt, attn_impl=impl))
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp),
                         device="cpu", dtype=tdt)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 40))
    patches = rng.standard_normal((2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks), patches=jnp.asarray(patches)),
                      np.float32)
    got = m.forward(tp, torch.from_numpy(toks), patches=torch.from_numpy(patches))
    assert got.shape == (2, 8 + 40, cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **logit_tol(dtype, want))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "patches": patches}
    jl, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet = m.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL[dtype])
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == 2 * 39
    # without patches the model is a plain decoder over the tokens
    want = np.asarray(jm.forward(jp, jnp.asarray(toks)), np.float32)
    np.testing.assert_allclose(m.forward(tp, torch.from_numpy(toks)).numpy(), want,
                               **logit_tol(dtype, want))


def test_gradients_with_patches_match_reference(models):
    """Every leaf's gradient of the loss over a ``SyntheticLM`` batch with
    patches against ``jax.grad``, at 1e-4 of the leaf's largest value (the
    bound of ``test_torch_grads.py``)."""
    from repro_torch.tree import tree_map

    jm, jp, m, p = models
    jb = JSyntheticLM(jm.cfg, JDataConfig(seq_len=16, global_batch=2, seed=0)).batch(0)
    tb = SyntheticLM(m.cfg, DataConfig(seq_len=16, global_batch=2, seed=0), device="cpu").batch(0)
    want = jax.grad(lambda pp: jm.loss(pp, jb)[0])(jp)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(m.loss(leaves, tb)[0], flat)
    by_id = {id(t): g for t, g in zip(flat, grads)}
    got = weights.params_to_jax(tree_map(lambda t: by_id[id(t)], leaves))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * float(np.abs(b).max()))


def test_patches_move_the_text_logits(models):
    """The fault control: other patches give other text logits, so the
    forward test sees them."""
    _, _, m, p = models
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 256, (1, 16)))
    a, b = (torch.from_numpy(rng.standard_normal((1, 8, 64)).astype(np.float32)) for _ in "ab")
    la, lb = (m.forward(p, toks, patches=x)[:, 8:] for x in (a, b))
    assert float((la - lb).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_width_tree_matches_reference(dtype, monkeypatch):
    """internvl2-1b whole: every leaf's shape through ``params_from_jax``
    (no new leaves: patches are inputs), the parameter count against
    ``jax.eval_shape``."""
    assert full_width_count(ARCH, dtype, monkeypatch) == 633_149_312


def full_width_count(arch: str, dtype, monkeypatch) -> int:
    """The full-width tree's parameter count, held three ways with nothing
    allocated: ``jax.eval_shape`` of the reference's init, that tree
    through ``params_from_jax`` (its leaves made as ``meta`` tensors) and
    the port's ``abstract_params``; the last two leaf for leaf."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    like = jax.eval_shape(JModel(jget_arch(arch), JRuntime(dtype=jdt)).init,
                          jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(like))
    monkeypatch.setattr(weights, "_tensor", lambda a, device, dt: torch.empty(
        a.shape, dtype=dt, device="meta"))
    bridged = params_from_jax(like, device="cpu", dtype=dtype)
    own = Model(get_arch(arch), ModelRuntime(dtype=dtype)).abstract_params()
    assert tree_map_with_path(lambda p, t: (p, tuple(t.shape), t.dtype), bridged) == (
        tree_map_with_path(lambda p, t: (p, tuple(t.shape), t.dtype), own))
    got = sum(t.numel() for t in tree_leaves(own))
    assert got == want
    return got


# ------------------------------------------------------------- serving
COUNTERS = (
    "dispatches", "prefill_dispatches", "decode_dispatches", "steps_executed",
    "tokens_emitted", "prompt_tokens_ingested", "prefix_hit_tokens", "preemptions",
    "tokens_discarded", "peak_pages", "page_allocs", "pages_in_use", "peak_cache_bytes",
)
BATCH = [("a", [1, 2, 3, 4, 5, 6, 7], 5, 0.0), ("b", [9, 8], 6, 0.0), ("c", [42], 4, 0.7),
         ("d", [5, 4, 3, 2, 1, 17, 23, 31, 44], 5, 0.0), ("e", [1, 2, 3, 4, 5, 6, 9], 3, 0.0)]
ENGINES = {
    "paged": dict(max_batch=3, max_len=32, prefill_chunk=4, page_size=8, total_pages=9,
                  cache_mode="paged", rng_seed=3),
    "dense": dict(max_batch=3, max_len=32, prefill_chunk=4, cache_mode="dense", rng_seed=3),
    "paged_grouped": dict(max_batch=2, max_len=32, prefill_chunk=4, page_size=8,
                          cache_mode="paged", dispatch_mode="grouped"),
}


def requests(cls, batch):
    return [cls(uid=u, prompt=list(p), max_new_tokens=n, temperature=t) for u, p, n, t in batch]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_matches_reference(models, engine):
    """Every prompt ingested one token a decode dispatch (a VLM takes no
    fused prefill): outputs (a temperature row among them) and every
    counter equal."""
    jm, jp, m, p = models
    kw = ENGINES[engine]
    jeng = JEngine(JModel(jm.cfg), jp, **kw)
    jeng.submit(requests(JRequest, BATCH))
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    eng = ServeEngine(m, p, device="cpu", **kw)
    eng.submit(requests(Request, BATCH))
    while eng.pending or eng.scheduler.has_active():
        eng.step()
        if eng.cache_mode == "paged":
            eng.cache_mgr.check_invariants()
    assert {r.uid: r.output for r in eng.finished} == want
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.prefill_dispatches == 0 and eng._use_prefill is jeng._use_prefill is False
    assert not m.supports_fused_prefill


REFUSALS = {
    "prefill_role": dict(worker_role="prefill"),
    "speculative_ngram": dict(speculative="ngram"),
    "speculative_draft": dict(speculative="draft"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_reference(models, name):
    jm, jp, m, p = models
    kw = dict(max_batch=2, max_len=32, prefill_chunk=4, cache_mode="paged", page_size=8,
              **REFUSALS[name])
    with pytest.raises(ValueError) as want:
        JEngine(JModel(jm.cfg), jp, **kw)
    with pytest.raises(ValueError) as got:
        ServeEngine(m, p, device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 4])
def test_kernel_path_at_the_decode_fold(dtype, T):
    """internvl's decode folds G = 7 query heads onto a KV head: under
    ``TENSOR_CORE_MIN_ROWS`` (9), the split-KV decode path; a verify-sized
    fold would go to the tensor cores."""
    cfg = get_arch(ARCH)
    g, hd = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    assert kernel_path(dtype, g * T, hd, hd) == ("decode" if T == 1 else "tensor_core")


# ------------------------------------------------------------- the payloads
JOB = {"arch": ARCH, "arch_overrides": "reduced", "device": "cpu"}
TRAIN = {**JOB, "seq_len": 16, "global_batch": 2, "lr": 1e-3, "warmup_steps": 1,
         "ckpt_every": 1}
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42], [5, 4, 3, 2, 1, 17, 23, 31, 44]]
SERVE = {**JOB, "max_new_tokens": 4, "max_len": 40, "max_batch": 2, "prefill_chunk": 4,
         "cache_mode": "paged", "page_size": 8}


def run_ds(core, root, payload, shared, groups):
    clk = core.VirtualClock()
    cfg = core.DSConfig(app_name="VLM", payload=payload, cluster_machines=1,
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
    (patches in every batch), an eval shard and a static paged serve job,
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
        # the gradients agree to ~1e-6 of each leaf's largest
        # (test_gradients_with_patches_match_reference), but AdamW's
        # m / sqrt(v) turns that into up to a few % of a step (lr 1e-3)
        # where a gradient element is near eps: every parameter within 10%
        # of one step
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-4)
    key = "runs/t/eval/shard0/METRICS.json"
    got, want = stores["port"].get_json(key), stores["ref"].get_json(key)
    assert got["ckpt_step"] == want["ckpt_step"] == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for b in (0, 1):
        key = f"serve/b{b}/RESULTS.json"
        assert stores["port"].get_json(key) == stores["ref"].get_json(key), key


def test_eval_runner_sees_the_patches(tmp_path):
    """The eval runner's loss is the loss over batches with patches: it
    equals ``Model.loss`` on ``SyntheticLM``'s batch, and differs from the
    loss without them."""
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
        bare = float(model.loss(params, {k: v for k, v in batch.items() if k != "patches"})[0])
    assert out["loss"] == pytest.approx(want, rel=1e-6)
    assert abs(bare - want) > 1e-4
