"""The port's ``ServeEngine`` for ``deepseek-v2-236b`` (MLA over the MoE),
plain path on the CPU, against the reference's engine on shared weights
at ``reduced()`` size.

Held: the paged engine (the latent pool ``kv_pages``) and the dense
engine (``c_kv``/``k_rope``) on the ragged, shared-prefix, mid-page,
preemption and eviction workloads, under ``dense`` and ``capacity``:
greedy tokens and every counter equal, prompts ingested one token a
decode dispatch (a MoE takes no fused prefill), ``page_bytes`` the
latent's 40 columns a slot; each copy-on-write of a latent page bit for
bit; the prefix store publishing the latent pages after decode-path
ingestion and a fresh engine hydrating them, each hydrated pool page bit
for bit the published one, tokens and counters equal to the reference's
engines on the same scenario; and the ``distributed-serve`` (paged and
dense) and ``distributed-eval`` payloads through each package's runtime
from the reference's seed-0 checkpoint."""

import shutil

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.launch.serve  # noqa: F401  (registers distributed-serve)
import repro.launch.train  # noqa: F401  (registers distributed-eval)
import repro_torch.core as tcore
import repro_torch.launch.serve  # noqa: F401
import repro_torch.launch.train  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.prefix_store import PrefixStore as JStore
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model, ModelRuntime, mla
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.cache_manager import KVCacheManager
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.prefix_store import PrefixStore, host_page

torch.set_num_threads(1)  # the test workers share the host's cores

ARCH = "deepseek-v2-236b"
COUNTERS = (
    "dispatches", "prefill_dispatches", "decode_dispatches", "steps_executed",
    "tokens_emitted", "prompt_tokens_ingested", "prefix_hit_tokens",
    "prompt_tokens_skipped", "prefix_hit_tokens_partial", "cow_partial_stitches",
    "cow_copies", "preemptions", "prefix_evictions", "tokens_discarded",
    "peak_pages", "page_allocs", "pages_in_use", "pages_shared_peak", "n_pages",
    "page_bytes", "peak_cache_bytes",
)
DENSE_COUNTERS = (
    "dispatches", "prefill_dispatches", "decode_dispatches", "steps_executed",
    "tokens_emitted", "prompt_tokens_ingested", "preemptions", "tokens_discarded",
    "peak_pages", "page_allocs", "pages_in_use", "peak_cache_bytes", "prefix_hit_tokens",
)
STORE_COUNTERS = ("prefix_store_pages_published", "prefix_store_pages_hydrated",
                  "prefix_store_tokens_hydrated", "prefix_store_hash_mismatches")
PREFIX = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25, 26, 27, 28]
MIDPAGE = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24]
BASE = dict(max_batch=2, max_len=32, prefill_chunk=4, page_size=8, cache_mode="paged")
WORKLOADS = {
    "ragged": ([("r0", [1, 2, 3, 4, 5, 6, 7], 4), ("r1", [9, 8], 5), ("r2", [42], 3),
                ("r3", [5, 4, 3, 2, 1], 4)], dict(BASE, total_pages=4)),
    "shared_prefix": ([("a", PREFIX + [50, 51], 4), ("b", PREFIX + [60, 61, 62], 4),
                       ("c", list(PREFIX), 4)], dict(BASE, total_pages=10)),
    "midpage": ([("a", MIDPAGE + [50, 51, 52, 53], 4), ("b", MIDPAGE + [60, 61], 4),
                 ("c", MIDPAGE + [70, 71, 72], 4)], dict(BASE, total_pages=12)),
    "preemption": ([(f"r{i}", [10 + i, 20 + i, 30 + i, 40 + i, 50 + i, 60 + i, 70 + i], 6)
                    for i in range(4)], dict(BASE, total_pages=3)),
    "eviction": ([(f"r{i}", [100 + (i % 3)] * 8 + [30 + i], 4) for i in range(4)],
                 dict(BASE, max_batch=1, total_pages=3)),
}


def requests(cls, batch):
    return [cls(uid=u, prompt=list(p), max_new_tokens=n) for u, p, n in batch]


@pytest.fixture(scope="module")
def weights():
    jp = JModel(jreduced(jget_arch(ARCH))).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def pair(weights, strategy: str):
    jp, p = weights
    return (JModel(jreduced(jget_arch(ARCH)), JRuntime(moe_strategy=strategy)), jp,
            Model(reduced(get_arch(ARCH)), ModelRuntime(moe_strategy=strategy)), p)


def run_both(models, batch, counters=COUNTERS, **kw):
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
    for name in counters:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.prefill_dispatches == 0 and not eng._use_prefill  # decode-path ingest
    return eng, jeng


@pytest.fixture
def cow_copies(monkeypatch):
    """Every copy-on-write of a pool page, held bit for bit: the copy's
    every layer equals its source's."""
    seen, real = [], KVCacheManager._copy_page

    def copy(self, src, dst):
        real(self, src, dst)
        for leaf in self._pool_leaves().values():
            assert torch.equal(leaf[:, dst], leaf[:, src])
        seen.append((src, dst))

    monkeypatch.setattr(KVCacheManager, "_copy_page", copy)
    return seen


@pytest.mark.parametrize("strategy", ["dense", "capacity"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_paged_engine_matches_reference(weights, cow_copies, workload, strategy):
    batch, kw = WORKLOADS[workload]
    eng, _ = run_both(pair(weights, strategy), batch, **kw)
    cfg = eng.model.cfg
    assert set(eng.cache) == {"page_table", "kv_pages"}
    assert eng.page_bytes == mla.mla_page_width(cfg) * cfg.n_layers * 8 * 4
    if workload == "preemption":
        assert eng.preemptions > 0
    if workload in ("shared_prefix", "midpage"):
        assert eng.prefix_hit_tokens > 0
        assert cow_copies and len(cow_copies) == eng.cow_copies + eng.cow_partial_stitches


@pytest.mark.parametrize("strategy", ["dense", "capacity"])
@pytest.mark.parametrize("workload", ["ragged", "shared_prefix"])
def test_dense_engine_matches_reference(weights, workload, strategy):
    batch, kw = WORKLOADS[workload]
    kw = {k: v for k, v in kw.items() if k not in ("page_size", "total_pages")}
    eng, _ = run_both(pair(weights, strategy), batch, DENSE_COUNTERS,
                      **dict(kw, cache_mode="dense"))
    assert set(eng.cache) == {"c_kv", "k_rope"}
    assert eng.peak_cache_bytes == sum(t.numel() * 4 for t in eng.cache.values())


# ------------------------------------------------------------- the prefix store
STORE_KW = dict(BASE, total_pages=10, prefix_cache=True)
PUBLISH = [("a", PREFIX + [50, 51], 3), ("b", PREFIX + [60, 61, 62], 3)]
HYDRATE = [("c", PREFIX + [70, 71], 3)]


def store_scenario(make, Req, root: str, hydrated: list):
    """Engine one publishes the shared prefix's two latent pages after
    ingesting it on the decode path; a fresh engine two on the same store
    hydrates them for a third request.  ``(outputs, counters of each)``."""
    a = make(root)
    a.submit(requests(Req, PUBLISH))
    outs = {r.uid: r.output for r in a.run_to_completion()}
    a.cache_mgr.flush_store()
    b = make(root)
    b.submit(requests(Req, HYDRATE))
    outs.update({r.uid: r.output for r in b.run_to_completion()})
    b.cache_mgr.flush_store()
    counts = [{n: getattr(e.stats, n) for n in STORE_COUNTERS + ("prompt_tokens_skipped",)}
              for e in (a, b)]
    if hydrated is not None:
        hydrated.append((a, b))
    return outs, counts


def test_latent_pages_publish_and_hydrate_like_the_reference(weights, monkeypatch, tmp_path):
    """Tokens and counters equal the reference's on the same scenario; the
    pages engine one published are its pool pages bit for bit, and every
    page engine two hydrated is the published page bit for bit."""
    jm, jp, m, p = pair(weights, "dense")
    writes = []
    real_write = KVCacheManager._write_page

    def write_page(self, pid, arrays):
        real_write(self, pid, arrays)
        writes.append((pid, {n: a.copy() for n, a in arrays.items()},
                       {n: host_page(leaf[:, pid]) for n, leaf in self._pool_leaves().items()}))

    monkeypatch.setattr(KVCacheManager, "_write_page", write_page)
    want, want_counts = store_scenario(
        lambda root: JEngine(jm, jp, prefix_store=JStore(jcore.ObjectStore(root), "mla"),
                             **STORE_KW), JRequest, str(tmp_path / "ref"), None)
    engines = []
    got, got_counts = store_scenario(
        lambda root: ServeEngine(m, p, device="cpu", prefix_store=PrefixStore(
            tcore.ObjectStore(root), "mla"), **STORE_KW), Request, str(tmp_path / "port"),
        engines)
    assert got == want and got_counts == want_counts
    assert got_counts[0]["prefix_store_pages_published"] == 2
    assert got_counts[1]["prefix_store_pages_hydrated"] == 2
    a, b = engines[0]
    like = a.cache_mgr._page_like()
    assert {n: t.shape for n, t in like.items()} == {"kv_pages": (2, 8, 40)}
    keys = a.cache_mgr._chunk_keys(PREFIX, 2)
    for node, key in zip(a.cache_mgr.prefix.match(PREFIX), keys):
        published = a.cache_mgr.store.fetch(key, like)
        pool = a.cache_mgr._page_arrays(node.page)
        assert all(np.array_equal(published[n], pool[n]) for n in like)
    assert len(writes) == 2
    for (pid, fetched, written), key in zip(writes, keys):
        published = a.cache_mgr.store.fetch(key, like)
        assert all(np.array_equal(fetched[n], published[n]) for n in like)
        assert all(np.array_equal(written[n], published[n]) for n in like)


# ------------------------------------------------------------- the payloads
JOB = {"arch": ARCH, "arch_overrides": "reduced", "device": "cpu", "run": "t"}
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42], [5, 4, 3, 2, 1, 17, 23, 31, 44]]
SERVE = {**JOB, "max_new_tokens": 4, "max_len": 40, "max_batch": 2, "prefill_chunk": 4}


def run_ds(core, root, payload, shared, groups):
    clk = core.VirtualClock()
    cfg = core.DSConfig(app_name="MLA", payload=payload, cluster_machines=1,
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
    """A store holding the reference's seed-0 reduced deepseek as run ``t``
    at step 0, written by the reference."""
    root = tmp_path_factory.mktemp("seed")
    jm = JModel(jreduced(jget_arch(ARCH)))
    jckpt.save_checkpoint(jcore.ObjectStore(str(root)), "t", 0, jm.init(jax.random.PRNGKey(0)))
    return root


def test_eval_and_serve_payloads_match_reference(seeded, tmp_path):
    """An eval shard and static serve jobs (paged under ``capacity``, dense
    under ``dense``) on the reference's checkpoint, each through both
    packages' runtimes."""
    stores = {}
    jobs = {"paged": {"cache_mode": "paged", "page_size": 8, "moe_strategy": "capacity"},
            "dense": {"cache_mode": "dense", "moe_strategy": "dense"}}
    for name, core in (("ref", jcore), ("port", tcore)):
        root = tmp_path / name
        shutil.copytree(seeded / "ckpt", root / "ckpt")
        run_ds(core, root, "distributed-eval",
               {**JOB, "seq_len": 16, "global_batch": 2, "n_batches": 1}, [{"shard": 0}])
        for mode, knobs in jobs.items():
            run_ds(core, root, "distributed-serve", {**SERVE, **knobs},
                   [{"prompts": PROMPTS[:2], "output_prefix": f"serve/{mode}0"},
                    {"prompts": PROMPTS[2:], "output_prefix": f"serve/{mode}1"}])
        stores[name] = jcore.ObjectStore(str(root))
    key = "runs/t/eval/shard0/METRICS.json"
    got, want = stores["port"].get_json(key), stores["ref"].get_json(key)
    assert got["ckpt_step"] == want["ckpt_step"] == 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for mode in jobs:
        for b in (0, 1):
            key = f"serve/{mode}{b}/RESULTS.json"
            assert stores["port"].get_json(key) == stores["ref"].get_json(key), key
