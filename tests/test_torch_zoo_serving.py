"""The port's paged ``ServeEngine`` (plain path on the CPU) for the dense
zoo at ``reduced()`` size against the reference's
``ServeEngine(cache_mode="paged")`` on shared weights (``bq``/``bk``/``bv``
drawn non-zero, their init being zeros): outputs and the dispatch, page
and prefix counters exactly equal on ragged prompts, a shared prefix,
mid-page divergence, small-pool preemption with temperature rows and
decode-path ingestion.  MQA (``granite-34b``) folds all four query heads
of its one KV head into the paged op (G = ``n_heads``).  The dense engine
for the same archs is a case of ``test_torch_serving_dense.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(1)  # the test workers share the host's cores

ZOO = ("granite-34b", "qwen2-72b", "nemotron-4-340b")
COUNTERS = (
    "dispatches", "prefill_dispatches", "decode_dispatches", "steps_executed",
    "tokens_emitted", "prompt_tokens_ingested", "prefix_hit_tokens",
    "prompt_tokens_skipped", "prefix_hit_tokens_partial", "cow_partial_stitches",
    "cow_copies", "preemptions", "prefix_evictions", "tokens_discarded",
    "peak_pages", "page_allocs", "pages_in_use", "pages_shared_peak", "n_pages",
    "page_bytes", "peak_cache_bytes",
)
PREFIX = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25, 26, 27, 28]
MIDPAGE = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24]
RAGGED = [(f"r{i}", p, 4, 0.0) for i, p in enumerate(
    [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42], [5, 4, 3, 2, 1], [17, 23, 31]])]
BASE = dict(max_batch=2, max_len=32, prefill_chunk=4, page_size=8, cache_mode="paged")
WORKLOADS = {  # (uid, prompt, max_new_tokens, temperature) requests, engine knobs
    "ragged": (RAGGED, dict(BASE, total_pages=4)),
    "shared_prefix": ([("a", PREFIX + [50, 51], 4, 0.0), ("b", PREFIX + [60, 61, 62], 4, 0.0),
                       ("c", list(PREFIX), 4, 0.0)], dict(BASE, total_pages=10)),
    "midpage_token": ([("a", MIDPAGE + [50, 51, 52, 53], 4, 0.0), ("b", MIDPAGE + [60, 61], 4, 0.0),
                       ("c", MIDPAGE + [70, 71, 72], 4, 0.0)], dict(BASE, total_pages=12)),
    "temperature_preemption": (
        [(f"r{i}", [10 + i, 20 + i, 30 + i, 40 + i, 50 + i, 60 + i, 70 + i], 6, 0.7 * (i % 2))
         for i in range(4)], dict(BASE, total_pages=3, rng_seed=5)),
    "decode_path_ingest": (RAGGED, dict(BASE, prefill_chunk=0, total_pages=4)),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ZOO:
        jm = JModel(jreduced(jget_arch(arch)))
        jp = jm.init(jax.random.PRNGKey(0))
        attn, rng = jp["layers"]["attn"], np.random.default_rng(9)
        for name in ("bq", "bk", "bv") if "bq" in attn else ():  # zeros at init: draw them
            draw = rng.standard_normal(attn[name].shape).astype(np.float32)
            attn[name] = jnp.asarray(draw * 0.5, attn[name].dtype)
        out[arch] = (jm, jp, Model(reduced(get_arch(arch))),
                     params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def requests(cls, batch):
    return [cls(uid=u, prompt=list(p), max_new_tokens=n, temperature=t) for u, p, n, t in batch]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("arch", ZOO)
def test_paged_engine_matches_reference(models, arch, workload):
    jm, jp, m, p = models[arch]
    batch, kw = WORKLOADS[workload]
    jeng = JEngine(jm, jp, **kw)
    jeng.submit(requests(JRequest, batch))
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    eng = ServeEngine(m, p, device="cpu", **kw)
    eng.submit(requests(Request, batch))
    while eng.pending or eng.scheduler.has_active():
        eng.step()
        eng.cache_mgr.check_invariants()
    assert eng.cache_mode == "paged"
    assert {r.uid: r.output for r in eng.finished} == want
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    if workload == "shared_prefix":
        assert eng.prefix_hit_tokens > 0
    if workload == "midpage_token":
        assert eng.cow_partial_stitches > 0
    if workload == "temperature_preemption":
        assert eng.preemptions > 0
    if workload == "decode_path_ingest":
        assert eng.prefill_dispatches == 0
