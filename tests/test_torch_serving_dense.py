"""The port's ``ServeEngine`` on the dense (per-slot) cache, plain path on
the CPU, against the reference's dense engine (its default) on shared
weights, for reduced ``ds-paper-100m`` (KV rows) and reduced
``mamba2-1.3b`` (SSM state rows): greedy outputs and every counter
exactly equal over refills into freed rows, decode-path ingestion, host
sampling and drain refill; the SSM engine's fused prefill against the
sequential greedy oracle (``tests/test_serving.py``'s case); and the
reference's four refusals for recurrent families."""

import jax
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

COUNTERS = (
    "dispatches", "prefill_dispatches", "decode_dispatches", "steps_executed",
    "tokens_emitted", "prompt_tokens_ingested", "preemptions", "tokens_discarded",
    "peak_pages", "page_allocs", "pages_in_use", "peak_cache_bytes",
)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42], [5, 4, 3, 2, 1], [17, 23, 31, 8, 8, 8, 8, 8, 2]]
BASE = dict(max_batch=2, max_len=32, prefill_chunk=4)
WORKLOADS = {  # max_batch 2 over 5 requests: every row is refilled after a finish
    "refill": dict(BASE),
    "decode_path_ingest": dict(BASE, prefill_chunk=0),
    "host_sampling": dict(BASE, sample_on_device=False),
    "drain_refill": dict(BASE, max_batch=3, refill_policy="drain"),
}
ARCHS = ("ds-paper-100m", "mamba2-1.3b")


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jm = JModel(jreduced(jget_arch(arch)))
        jp = jm.init(jax.random.PRNGKey(0))
        out[arch] = (jm, jp, Model(reduced(get_arch(arch))),
                     params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def requests(cls, max_new=4):
    return [cls(uid=f"r{i}", prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(PROMPTS)]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_matches_reference(models, arch, workload):
    jm, jp, m, p = models[arch]
    kw = WORKLOADS[workload]
    jeng = JEngine(jm, jp, **kw)
    jeng.submit(requests(JRequest))
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    eng = ServeEngine(m, p, device="cpu", **kw)
    assert eng.cache_mode == "dense" and eng._use_prefill == jeng._use_prefill
    eng.submit(requests(Request))
    got = {r.uid: r.output for r in eng.run_to_completion()}
    assert got == want
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.snapshot()["timing"] == jeng.snapshot()["timing"]
    assert "total_pages" not in eng.snapshot()


def _greedy_reference(model, params, prompt, max_new, max_len):
    """Sequential single-request greedy decode on a fresh dense cache."""
    cache = model.init_cache(1, max_len, device="cpu")
    toks, out = list(prompt), []
    for pos in range(len(prompt) + max_new - 1):
        t = toks[pos] if pos < len(toks) else out[-1]
        logits, cache = model.decode_step(params, cache, torch.tensor([[t]]), torch.tensor([pos]))
        if pos >= len(prompt) - 1:
            out.append(int(torch.argmax(logits[0, 0, :model.cfg.vocab_size])))
            if len(out) >= max_new:
                break
    return out


def test_ssm_fused_prefill_matches_sequential_reference(models):
    """Recurrent state through chunked prefill (conv window hand-off,
    dt-masked padding, rows re-zeroed at admission) reproduces the
    token-at-a-time oracle."""
    _, _, m, p = models["mamba2-1.3b"]
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42]]
    refs = [_greedy_reference(m, p, pr, 3, 32) for pr in prompts]
    eng = ServeEngine(m, p, device="cpu", max_batch=2, max_len=32, prefill_chunk=4)
    eng.submit([Request(uid=f"r{i}", prompt=list(pr), max_new_tokens=3)
                for i, pr in enumerate(prompts)])
    finished = eng.run_to_completion()
    assert eng._use_prefill and eng.prefill_dispatches > 0
    by_uid = {r.uid: r.output for r in finished}
    for i, ref in enumerate(refs):
        assert by_uid[f"r{i}"] == ref, f"request {i}"


def test_admission_zeroes_every_state_row(models):
    _, _, m, p = models["mamba2-1.3b"]
    eng = ServeEngine(m, p, device="cpu", max_batch=2, max_len=32, prefill_chunk=4)
    for leaf in eng.cache["state"].values():
        leaf.fill_(3.0)
    eng.cache_mgr.reset_row(1)
    for leaf in eng.cache["state"].values():
        assert (leaf[:, 1] == 0).all() and (leaf[:, 0] == 3.0).all()


REFUSALS = {
    "cache_mode='paged'": (dict(cache_mode="paged"), "no pageable KV cache"),
    "grouped": (dict(dispatch_mode="grouped"), "corrupts recurrent"),
    "speculative": (dict(speculative="ngram"), "cannot roll back recurrent"),
    "prefill_token_budget": (dict(prefill_token_budget=4), "mid-prefill"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_recurrent_family_refusals_match_reference(models, name):
    """The reference's ValueErrors, with its messages, before the port's
    own refusals of what is not ported."""
    jm, jp, m, p = models["mamba2-1.3b"]
    knob, msg = REFUSALS[name]
    with pytest.raises(ValueError, match=msg):
        JEngine(jm, jp, **knob)
    with pytest.raises(ValueError, match=msg):
        ServeEngine(m, p, device="cpu", **knob)
