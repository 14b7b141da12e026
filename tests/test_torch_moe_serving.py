"""The port's ``ServeEngine`` for the MoE family and the rolling
sliding-window cache, plain path on the CPU, against the reference's
engine on shared weights at ``reduced()`` size.

Held: reduced ``mixtral-8x7b`` (window 32, so 128 rolling slots) on the
dense cache with prompts plus new tokens past 128 positions, so the cache
wraps, fused and grouped, under ``dense`` and ``capacity`` (4 rows: a
dispatch's capacity drops tokens, parked rows taking their share as in
the reference): greedy tokens and every counter equal, prompts ingested
one token a decode dispatch (MoE has no fused prefill); the paged engine
for a MoE without a window; a windowed dense model whose cache does not
roll (fused prefill under the window) and one whose cache rolls
(decode-path ingest), and ``cache_is_rolling`` against the reference's;
the prefill-role and speculative refusals on a rolling cache, message for
message; and ``distributed-train``, ``-eval`` and ``-serve`` payloads for
reduced mixtral through each package's runtime from the reference's seed-0
checkpoint."""

import shutil

import jax
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
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model, ModelRuntime, moe
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(1)  # the test workers share the host's cores

ARCH = "mixtral-8x7b"
COUNTERS = (
    "dispatches", "prefill_dispatches", "decode_dispatches", "steps_executed",
    "tokens_emitted", "prompt_tokens_ingested", "preemptions", "tokens_discarded",
    "peak_pages", "page_allocs", "pages_in_use", "peak_cache_bytes", "prefix_hit_tokens",
)
_rng = np.random.default_rng(12)
# (uid, prompt, max_new_tokens): r0 runs to position 137, past the 128 rolling slots
ROLLING = [("r0", _rng.integers(1, 256, 124).tolist(), 14),
           ("r1", _rng.integers(1, 256, 21).tolist(), 8),
           ("r2", [5, 4, 3, 2, 1], 6), ("r3", [42], 5), ("r4", [9, 8, 7, 6, 5, 4, 3], 4)]
ROLLING_KW = dict(max_batch=4, max_len=160, prefill_chunk=4)
SHORT = [("a", [1, 2, 3, 4, 5, 6, 7], 5), ("b", [9, 8], 6), ("c", [42], 4),
         ("d", [5, 4, 3, 2, 1, 17, 23, 31, 44], 5)]


def requests(cls, batch):
    return [cls(uid=u, prompt=list(p), max_new_tokens=n) for u, p, n in batch]


def pair(arch: str, strategy: str = "dense", **overrides):
    """(jax model, jax params, port model, port params) on one weight set."""
    jm = JModel(jreduced(jget_arch(arch), **overrides), JRuntime(moe_strategy=strategy))
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(reduced(get_arch(arch), **overrides), ModelRuntime(moe_strategy=strategy))
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def run_both(models, batch, **kw):
    jm, jp, m, p = models
    jeng = JEngine(jm, jp, **kw)
    jeng.submit(requests(JRequest, batch))
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    eng = ServeEngine(m, p, device="cpu", **kw)
    eng.submit(requests(Request, batch))
    while eng.pending or eng.scheduler.has_active():
        eng.step()
        if eng.cache_mode == "paged":
            eng.cache_mgr.check_invariants()
    assert {r.uid: r.output for r in eng.finished} == want
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng._use_prefill == jeng._use_prefill
    assert eng.cache_mgr.cache_is_rolling() == jeng.cache_mgr.cache_is_rolling()
    return eng, jeng


@pytest.fixture
def dropped(monkeypatch):
    """Counts the entries the port's capacity paths drop, call by call."""
    cfg, seen, route = reduced(get_arch(ARCH)), [], moe.route

    def counting(p, x, top_k):
        gates, ids = route(p, x, top_k)
        counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
        seen.append(int((counts - moe.capacity(ids.shape[0], cfg)).clamp(min=0).sum()))
        return gates, ids

    monkeypatch.setattr(moe, "route", counting)
    return seen


@pytest.mark.parametrize("dispatch_mode", ["fused", "grouped"])
@pytest.mark.parametrize("strategy", ["dense", "capacity"])
def test_rolling_cache_engine_matches_reference(dropped, strategy, dispatch_mode):
    eng, _ = run_both(pair(ARCH, strategy), ROLLING, dispatch_mode=dispatch_mode, **ROLLING_KW)
    assert eng.cache["k"].shape[2] == 128 < eng.max_len and eng.cache_mgr.cache_is_rolling()
    assert eng.prefill_dispatches == 0 and not eng._use_prefill  # decode-path ingest
    r0 = next(r for r in eng.finished if r.uid == "r0")
    assert len(r0.prompt) + len(r0.output) > 128  # the cache wrapped
    if strategy == "capacity":
        assert sum(dropped) > 0  # 4 rows, capacity 3: some dispatch dropped entries


@pytest.mark.parametrize("strategy", ["dense", "capacity"])
def test_paged_moe_engine_matches_reference(strategy):
    """A MoE without a window pages its cache: the reference's paged MoE
    decode, prompts still ingested one token a decode dispatch."""
    eng, _ = run_both(pair(ARCH, strategy, sliding_window=0), SHORT + SHORT[:2],
                      max_batch=3, max_len=32, prefill_chunk=4, page_size=8, total_pages=9,
                      cache_mode="paged")
    assert eng.cache_mode == "paged" and eng.prefill_dispatches == 0


@pytest.mark.parametrize("max_len,rolling", [(96, False), (160, True)])
def test_windowed_dense_engine_matches_reference(max_len, rolling):
    """ds-paper-100m with a 32-token window: at ``max_len`` 96 the cache has
    96 slots and does not roll, so prompts take the fused prefill under the
    window; at 160 it rolls (128 slots) and prompts ingest on the decode
    path."""
    batch = [("w0", list(range(1, 60)), 6), ("w1", list(range(100, 141)), 8)] + SHORT[:2]
    eng, _ = run_both(pair("ds-paper-100m", sliding_window=32), batch, max_batch=2,
                      max_len=max_len, prefill_chunk=16)
    assert eng.cache_mgr.cache_is_rolling() == rolling
    assert (eng.prefill_dispatches > 0) == (not rolling)


REFUSALS = {
    "prefill_role": dict(worker_role="prefill"),
    "speculative": dict(speculative="ngram"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
@pytest.mark.parametrize("arch,overrides", [(ARCH, {}), ("ds-paper-100m", {"sliding_window": 32})],
                         ids=["mixtral", "windowed_dense"])
def test_rolling_cache_refusals_match_reference(arch, overrides, name):
    jm, jp, m, p = pair(arch, **overrides)
    kw = dict(max_batch=2, max_len=160, prefill_chunk=4, **REFUSALS[name])
    with pytest.raises(ValueError) as want:
        JEngine(jm, jp, **kw)
    with pytest.raises(ValueError) as got:
        ServeEngine(m, p, device="cpu", **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- the payloads
JOB = {"arch": ARCH, "arch_overrides": "reduced", "device": "cpu"}
TRAIN = {**JOB, "seq_len": 16, "global_batch": 2, "lr": 1e-3, "warmup_steps": 1,
         "ckpt_every": 1}
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42], [5, 4, 3, 2, 1, 17, 23, 31, 44]]
SERVE = {**JOB, "max_new_tokens": 4, "max_len": 40, "max_batch": 2, "prefill_chunk": 4}


def run_ds(core, root, payload, shared, groups):
    clk = core.VirtualClock()
    cfg = core.DSConfig(app_name="MoE", payload=payload, cluster_machines=1,
                        tasks_per_machine=1, machine_type=["sim.large"], machine_price=1.0,
                        sqs_message_visibility=240.0, max_receive_count=8,
                        check_if_done=False)
    rt = core.DSRuntime(cfg, store_root=str(root), clock=clk)
    rt.setup()
    rt.submit_job(core.JobFile(shared=dict(shared), groups=[dict(g) for g in groups]))
    rt.start_cluster(core.FleetFile(startup_seconds=0.0))
    summary = core.SimRunner(rt, tick_seconds=30.0).run(max_ticks=400)
    assert summary.jobs_failed == 0 and summary.jobs_done == len(groups), summary


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A store holding the reference's seed-0 reduced mixtral as run ``t``
    at step 0, written by the reference."""
    root = tmp_path_factory.mktemp("seed")
    jm = JModel(jreduced(jget_arch(ARCH)))
    jckpt.save_checkpoint(jcore.ObjectStore(str(root)), "t", 0, jm.init(jax.random.PRNGKey(0)))
    return root


def both_roots(seeded, tmp_path):
    roots = {}
    for name, core in (("ref", jcore), ("port", tcore)):
        roots[name] = (tmp_path / name, core)
        shutil.copytree(seeded / "ckpt", tmp_path / name / "ckpt")
    return roots


def test_train_eval_and_serve_payloads_match_reference(seeded, tmp_path):
    """Two spans of one step, then an eval shard and a static serve job
    (``dense`` and ``capacity``), each through both packages' runtimes."""
    roots = both_roots(seeded, tmp_path)
    stores = {}
    for name, (root, core) in roots.items():
        jf = core.step_span_job_file(arch=ARCH, total_steps=2, span=1, run="t",
                                     shared=dict(TRAIN, total_steps=2))
        run_ds(core, root, "distributed-train", jf.shared, jf.groups)
        run_ds(core, root, "distributed-eval", {**TRAIN, "run": "t", "n_batches": 1},
               [{"shard": 0}])
        for strategy in ("dense", "capacity"):
            run_ds(core, root, "distributed-serve",
                   {**SERVE, "run": "t", "moe_strategy": strategy},
                   [{"prompts": PROMPTS[:2], "output_prefix": f"serve/{strategy}0"},
                    {"prompts": PROMPTS[2:], "output_prefix": f"serve/{strategy}1"}])
        stores[name] = jcore.ObjectStore(str(root))
    like = jax.eval_shape(JModel(jreduced(jget_arch(ARCH))).init, jax.random.PRNGKey(0))
    for step in (1, 2):
        want, wmeta = jckpt.restore_checkpoint(stores["ref"], "t", step, like)
        got, gmeta = jckpt.restore_checkpoint(stores["port"], "t", step, like)
        np.testing.assert_allclose(gmeta["loss"], wmeta["loss"], rtol=1e-5)
        # 1% of one AdamW step at lr 1e-3: float32 sums ordered unlike the
        # reference's move a few parameters by an ulp-sized update
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-5)
    key = "runs/t/eval/shard0/METRICS.json"
    got, want = stores["port"].get_json(key), stores["ref"].get_json(key)
    assert got["ckpt_step"] == want["ckpt_step"] == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for strategy in ("dense", "capacity"):
        for b in (0, 1):
            key = f"serve/{strategy}{b}/RESULTS.json"
            assert stores["port"].get_json(key) == stores["ref"].get_json(key), key
