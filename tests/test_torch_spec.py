"""The port's speculative engine (plain path on the CPU) against the
reference's on shared weights: ``ngram`` and ``draft`` proposers,
``spec_k`` 1, 4 and 8, paged and dense, on the reference test's mixed
greedy, temperature, stop-token and ``max_len`` requests: tokens, engine
counters and the five speculative counters equal, the allocator
invariants checked after every tick; the plain engine's tokens; a pool
the plain engine just fits at ``spec_k`` 8; preemption replays across
``spec_k``; and the reference's knob validation, message for message.
The draft model is ds-paper-100m's reduced config from ``PRNGKey(7)``,
shared through ``params_from_jax``.  The verify dispatch and the n-gram
proposer alone are in ``test_torch_verify.py``."""

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
from test_torch_serving import COUNTERS as PAGED_COUNTERS
from test_torch_serving_dense import COUNTERS as DENSE_COUNTERS

torch.set_num_threads(1)  # the test workers share the host's cores

SPEC_COUNTERS = ("spec_dispatches", "draft_dispatches", "draft_tokens_proposed",
                 "draft_tokens_accepted", "spec_tokens_emitted")


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, jax draft params, port model, port params,
    port draft params): the target from PRNGKey(0), the draft from 7."""
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jp, jd = jm.init(jax.random.PRNGKey(0)), jm.init(jax.random.PRNGKey(7))
    m = Model(reduced(get_arch("ds-paper-100m")))

    def port(tree):
        return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")

    return jm, jp, jd, m, port(jp), port(jd)


def mixed_requests(cls):
    """The reference test's mix: greedy and temperature rows, a stop-token
    row and a row cut at ``max_len``."""
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42], [5, 4, 3, 2, 1]]
    reqs = [cls(uid=f"r{i}", prompt=list(p), max_new_tokens=10,
                temperature=0.0 if i % 2 == 0 else 0.8) for i, p in enumerate(prompts)]
    reqs.append(cls(uid="stop", prompt=[3, 1, 4], max_new_tokens=10, stop_token=7))
    reqs.append(cls(uid="long", prompt=[2, 7, 1, 8], max_new_tokens=64))
    return reqs


def run_pair(models, reqs, **kw):
    """The same requests through the reference engine and the port's
    (invariants checked after every port tick); both engines."""
    jm, jp, jd, m, p, pd = models
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("speculative") == "draft":
        jkw.update(draft_model=jm, draft_params=jd)
        pkw.update(draft_model=m, draft_params=pd)
    jeng = JEngine(jm, jp, **jkw)
    jeng.submit(reqs(JRequest))
    jeng.run_to_completion()
    eng = ServeEngine(m, p, device="cpu", **pkw)
    eng.submit(reqs(Request))
    while eng.pending or eng.scheduler.has_active():
        eng.step()
        eng.cache_mgr.check_invariants()
    return jeng, eng


def outputs(eng):
    return {r.uid: r.output for r in eng.finished}


def assert_same(jeng, eng, counters):
    assert outputs(eng) == outputs(jeng)
    for name in counters + SPEC_COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.stats.snapshot() == jeng.stats.snapshot()
    assert eng.snapshot()["timing"] == jeng.snapshot()["timing"]


# ---------------------------------------------------------------- the engine
@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
@pytest.mark.parametrize("spec_k", [1, 4, 8])
@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_spec_engine_matches_reference(models, proposer, spec_k, cache_mode):
    kw = dict(max_batch=3, max_len=32, speculative=proposer, spec_k=spec_k,
              cache_mode=cache_mode)
    if cache_mode == "paged":
        kw["page_size"] = 8
    jeng, eng = run_pair(models, mixed_requests, **kw)
    assert_same(jeng, eng, PAGED_COUNTERS if cache_mode == "paged" else DENSE_COUNTERS)
    assert eng.spec_dispatches > 0 and eng.draft_tokens_proposed > 0
    if proposer == "draft":
        assert eng.draft_dispatches > 0
        # a separately seeded draft is mostly wrong: rollback runs
        assert eng.draft_tokens_accepted < eng.draft_tokens_proposed
    assert len(outputs(eng)["long"]) < 64  # cut at max_len


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_spec_outputs_equal_the_plain_engine(models, proposer):
    """Speculation changes tokens per dispatch, never the tokens."""
    _, _, _, m, p, pd = models
    kw = dict(max_batch=3, max_len=32, cache_mode="paged", page_size=8)
    plain = ServeEngine(m, p, device="cpu", **kw)
    plain.submit(mixed_requests(Request))
    plain.run_to_completion()
    extra = dict(draft_model=m, draft_params=pd) if proposer == "draft" else {}
    spec = ServeEngine(m, p, device="cpu", speculative=proposer, spec_k=4, **kw, **extra)
    spec.submit(mixed_requests(Request))
    spec.run_to_completion()
    assert outputs(spec) == outputs(plain)
    assert spec.dispatches <= plain.dispatches
    assert spec.stats.snapshot()["accepted_per_dispatch"] > 0


def test_spec_never_ooms_a_pool_the_plain_engine_fits(models):
    """Draft positions are best-effort: on a pool sized for the plain run
    (one slot, 4 pages of 8 for a 4-token prompt and 28 new tokens) the
    speculative engine at ``spec_k`` 8 shrinks its drafts near the pool's
    edge, as the reference does, and emits the plain engine's tokens."""
    def reqs(cls):
        return [cls(uid="r", prompt=[5, 9, 2, 7], max_new_tokens=28)]

    kw = dict(max_batch=1, max_len=40, cache_mode="paged", page_size=8, total_pages=4)
    _, plain = run_pair(models, reqs, **kw)
    jeng, eng = run_pair(models, reqs, speculative="ngram", spec_k=8, **kw)
    assert_same(jeng, eng, PAGED_COUNTERS)
    assert outputs(eng) == outputs(plain) and len(outputs(eng)["r"]) == 28


def test_preempted_replay_identical_across_spec_k(models):
    """A request's sampling stream depends only on the tokens it emitted:
    under a pool that preempts mid-generation, temperature rows give the
    reference's tokens and counters at ``spec_k`` 1 and 4, and the plain
    engine's tokens."""
    def reqs(cls):
        return [cls(uid=f"r{i}", prompt=[10 * i + j for j in range(1, 7)], max_new_tokens=8,
                    temperature=0.7) for i in range(5)]

    kw = dict(max_batch=3, max_len=16, cache_mode="paged", page_size=8, total_pages=5)
    _, plain = run_pair(models, reqs, **kw)
    preempted = plain.preemptions > 0
    for k in (1, 4):
        jeng, eng = run_pair(models, reqs, speculative="ngram", spec_k=k, **kw)
        assert_same(jeng, eng, PAGED_COUNTERS)
        assert outputs(eng) == outputs(plain)
        preempted |= eng.preemptions > 0
    assert preempted, "the pool never forced a preemption"


# ------------------------------------------------------------------- knobs
KNOBS = {
    "unknown_proposer": dict(speculative="both"),
    "spec_k_0": dict(speculative="ngram", spec_k=0),
    "draft_without_speculative": "draft_model",
    "draft_without_model": dict(speculative="draft"),
    "host_sampling": dict(speculative="ngram", sample_on_device=False),
    "no_fused_prefill": dict(speculative="ngram", prefill_chunk=0),
    "grouped_speculative": dict(speculative="ngram", dispatch_mode="grouped"),
    "grouped_budget": dict(dispatch_mode="grouped", prefill_token_budget=4),
}


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_spec_knob_validation_matches_reference(models, name):
    jm, jp, jd, m, p, pd = models
    knob = KNOBS[name]
    jknob = dict(draft_model=jm, draft_params=jd) if knob == "draft_model" else knob
    pknob = dict(draft_model=m, draft_params=pd) if knob == "draft_model" else knob
    with pytest.raises(ValueError) as want:
        JEngine(jm, jp, max_batch=2, max_len=32, **jknob)
    with pytest.raises(ValueError) as got:
        ServeEngine(m, p, device="cpu", max_batch=2, max_len=32, **pknob)
    assert str(got.value) == str(want.value)


def test_draft_params_must_live_on_the_engine_device(models):
    _, _, _, m, p, pd = models
    moved = {**pd, "embed": pd["embed"].to("meta")}
    with pytest.raises(ValueError, match="draft_params live on"):
        ServeEngine(m, p, device="cpu", speculative="draft", draft_model=m,
                    draft_params=moved)
