"""The port's paged ``ServeEngine`` (plain path on the CPU) against the
reference ``ServeEngine(cache_mode="paged")`` on shared weights: outputs
and the dispatch, page and prefix counters must be exactly equal on the
ragged, shared-prefix, mid-page-divergence, small-pool preemption,
eviction, budget, adaptive-pool and decode-path-ingestion workloads, and
on stop tokens (device and host sampling), temperature rows under
preemption, ``prefix_cache=False`` and rows cut at ``max_len``.  The allocator invariants are checked after every tick."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import prng
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(1)  # the test workers share the host's cores

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


def ragged():
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42], [5, 4, 3, 2, 1], [17, 23, 31]]
    return [(f"r{i}", p, 4) for i, p in enumerate(prompts)]


def shared_prefix():
    return [("a", PREFIX + [50, 51], 4), ("b", PREFIX + [60, 61, 62], 4),
            ("c", list(PREFIX), 4)]


def midpage():
    return [("a", MIDPAGE + [50, 51, 52, 53], 4), ("b", MIDPAGE + [60, 61], 4),
            ("c", MIDPAGE + [70, 71, 72], 4)]


def preemption():
    return [(f"r{i}", [10 + i, 20 + i, 30 + i, 40 + i, 50 + i, 60 + i, 70 + i], 6)
            for i in range(4)]


def eviction():
    return [(f"r{i}", [100 + (i % 3)] * 8 + [30 + i], 4) for i in range(4)]


def temperature_rows(reqs, temperature=0.7):
    """Every other request samples at ``temperature``."""
    return [(u, p, n, {"temperature": temperature if i % 2 else 0.0})
            for i, (u, p, n) in enumerate(reqs)]


BASE = dict(max_batch=2, max_len=32, prefill_chunk=4, page_size=8, cache_mode="paged")
# workloads whose even requests stop on their second greedy token
# (learned from a reference run without stop tokens)
STOP_WORKLOADS = ("stop_token", "stop_token_host_sampling")
WORKLOADS = {
    "ragged": ([ragged()], dict(BASE, total_pages=4)),
    "shared_prefix": ([shared_prefix()], dict(BASE, total_pages=10)),
    "midpage_token": ([midpage()], dict(BASE, total_pages=12)),
    "midpage_page_aligned": ([midpage()], dict(BASE, total_pages=12, prefix_match="page")),
    "preemption": ([preemption()], dict(BASE, total_pages=3)),
    "eviction": ([eviction()], dict(BASE, max_batch=1, total_pages=3)),
    "prefill_budget": ([shared_prefix() + ragged()[:2]],
                       dict(BASE, max_batch=3, total_pages=12, prefill_token_budget=3)),
    "adaptive_grow": ([[("tiny", [1, 2, 3], 2)], [("big", list(range(1, 41)), 8)]],
                      dict(BASE, max_len=64, total_pages=None)),
    "decode_path_ingest": ([shared_prefix()], dict(BASE, prefill_chunk=0, total_pages=10)),
    "host_sampling": ([ragged()], dict(BASE, total_pages=4, sample_on_device=False)),
    "drain_refill": ([ragged()], dict(BASE, total_pages=6, refill_policy="drain")),
    "stop_token": ([ragged()], dict(BASE, total_pages=4)),
    "stop_token_host_sampling": ([ragged()], dict(BASE, total_pages=4, sample_on_device=False)),
    "temperature_preemption": ([temperature_rows(preemption())],
                               dict(BASE, total_pages=3, rng_seed=5)),
    "no_prefix_cache": ([shared_prefix()], dict(BASE, total_pages=10, prefix_cache=False)),
    "max_len_cut": ([[(u, p, 40) for u, p, _ in ragged()]], dict(BASE, total_pages=8)),
}


@pytest.fixture(scope="module")
def models():
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(reduced(get_arch("ds-paper-100m")))
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def requests(cls, batch):
    """Requests of one batch: ``(uid, prompt, max_new_tokens[, fields])``."""
    return [cls(uid=u, prompt=list(p), max_new_tokens=n, **(x[0] if x else {}))
            for u, p, n, *x in batch]


def run_port(engine, batches):
    for batch in batches:
        engine.submit(requests(Request, batch))
        while engine.pending or engine.scheduler.has_active():
            engine.step()
            engine.cache_mgr.check_invariants()
    return {r.uid: r.output for r in engine.finished}


def run_jax(engine, batches):
    for batch in batches:
        engine.submit(requests(JRequest, batch))
        engine.run_to_completion()
    return {r.uid: r.output for r in engine.finished}


def with_stops(outs, batches):
    """Even requests stop on the second token ``outs`` gave them."""
    return [[(u, p, n, {"stop_token": outs[u][1]} if i % 2 == 0 else {})
             for i, (u, p, n, *_) in enumerate(batch)] for batch in batches]


def workload_inputs(models, workload):
    batches, kw = WORKLOADS[workload]
    if workload in STOP_WORKLOADS:
        jm, jp, _, _ = models
        batches = with_stops(run_jax(JEngine(jm, jp, **kw), batches), batches)
    return batches, kw


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_engine_matches_reference(models, workload):
    jm, jp, m, p = models
    batches, kw = workload_inputs(models, workload)
    jeng = JEngine(jm, jp, **kw)
    want = run_jax(jeng, batches)
    eng = ServeEngine(m, p, device="cpu", **kw)
    got = run_port(eng, batches)
    assert got == want
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.snapshot()["timing"] == jeng.snapshot()["timing"]


def test_workloads_exercise_their_paths(models):
    """Each workload reaches the path it is named for (so the parity test
    above is not vacuous)."""
    _, _, m, p = models

    def run(name):
        batches, kw = workload_inputs(models, name)
        eng = ServeEngine(m, p, device="cpu", **kw)
        run_port(eng, batches)
        return eng

    assert run("ragged").page_allocs > 4  # freed pages reused
    sp = run("shared_prefix")
    assert sp.prefix_hit_tokens > 0 and sp.cow_copies > 0
    assert run("midpage_token").cow_partial_stitches > 0
    assert run("preemption").preemptions > 0
    assert run("eviction").prefix_evictions > 0
    batches, kw = WORKLOADS["adaptive_grow"]
    ag = ServeEngine(m, p, device="cpu", **kw)
    run_port(ag, batches[:1])
    small = ag.n_pages
    run_port(ag, batches[1:])
    assert ag.n_pages > small  # grown in place
    assert ag.cache["k_pages"].shape[1] == ag.n_pages
    assert (ag._table == ag.n_pages).all()  # drained rows hold the moved sentinel
    assert run("decode_path_ingest").prefill_dispatches == 0
    for name in STOP_WORKLOADS:  # the stop tokens end their requests early
        stopped = [r for r in run(name).finished if r.stop_token is not None]
        assert stopped and all(r.output[-1] == r.stop_token and len(r.output) <= 2
                               for r in stopped)
    assert run("temperature_preemption").preemptions > 0
    nopc = run("no_prefix_cache")
    assert nopc.prefix is None and nopc.prefix_hit_tokens == 0
    assert all(len(r.output) < 40 for r in run("max_len_cut").finished)


def test_temperature_rows_are_placement_independent(models):
    """Seeded temperature sampling keys each draw on (seed, stream, step):
    the same requests give the same tokens at any batch width and under
    preemption (the rerun replays the same draws)."""
    _, _, m, p = models

    def reqs():
        return [Request(uid=f"r{i}", prompt=[10 + i, 20 + i, 30 + i, 40 + i, 50 + i],
                        max_new_tokens=6, temperature=0.7) for i in range(4)]

    outs = []
    for kw in (dict(max_batch=1, total_pages=8), dict(max_batch=4, total_pages=16),
               dict(max_batch=2, total_pages=3)):
        eng = ServeEngine(m, p, device="cpu", max_len=32, prefill_chunk=4, page_size=8,
                          rng_seed=5, cache_mode="paged", **kw)
        eng.submit(reqs())
        outs.append({r.uid: r.output for r in eng.run_to_completion()})
    assert outs[0] == outs[1] == outs[2]
    greedy = ServeEngine(m, p, device="cpu", max_batch=4, max_len=32, prefill_chunk=4,
                         page_size=8, total_pages=16, rng_seed=5, cache_mode="paged")
    greedy.submit([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=6) for r in reqs()])
    assert {r.uid: r.output for r in greedy.run_to_completion()} != outs[0]


def test_pool_exhaustion_and_overlong_prompt_raise(models):
    _, _, m, p = models
    eng = ServeEngine(m, p, device="cpu", **dict(BASE, total_pages=1))
    eng.submit([Request(uid="big", prompt=[1, 2, 3, 4, 5, 6, 7], max_new_tokens=8)])
    with pytest.raises(RuntimeError, match="pool exhausted"):
        eng.run_to_completion()
    eng = ServeEngine(m, p, device="cpu", **dict(BASE, max_batch=1, max_len=16,
                                                   prefill_chunk=8))
    eng.submit([Request(uid="big", prompt=list(range(1, 25)), max_new_tokens=2)])
    with pytest.raises(ValueError, match="max_len"):
        eng.run_to_completion()


# ------------------------------------------------------ temperature sampling
def _no_near_tie(m, p, req, temperature, seed, gap=1e-3):
    """Every temperature draw of ``req`` had a clear winner: the top two
    Gumbel-perturbed scores differ by more than ``gap`` (the two
    libraries' ``log`` agree to ~1e-7, so no id can flip)."""
    import torch

    from repro_torch import prng

    toks = list(req.prompt)
    for step, tok in enumerate(req.output):
        logits = m.forward(p, torch.tensor([toks]))[0, -1, :m.cfg.vocab_size]
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(seed, device="cpu"), req.sample_stream), step)
        z = (logits - logits.max()) / temperature + prng.gumbel(key, logits.shape)
        top2 = torch.topk(z, 2).values
        assert int(torch.argmax(z)) == tok
        assert float(top2[0] - top2[1]) > gap, f"near-tie at step {step}"
        toks.append(tok)


def test_temperature_sampling_matches_reference_on_the_named_input(models):
    """ROADMAP Queue 3 item 1's input: reduced ds-paper-100m, prompt
    [10, 20, 30, 40, 50], temperature 0.7, rng_seed 5 -- the same ids as
    the reference's threefry draws."""
    jm, jp, m, p = models
    kw = dict(max_batch=2, max_len=32, prefill_chunk=4, page_size=8, total_pages=8,
              rng_seed=5)
    eng = ServeEngine(m, p, device="cpu", cache_mode="paged", **kw)
    eng.submit([Request(uid="t", prompt=[10, 20, 30, 40, 50], max_new_tokens=12,
                        temperature=0.7)])
    jeng = JEngine(jm, jp, cache_mode="paged", **kw)
    jeng.submit([JRequest(uid="t", prompt=[10, 20, 30, 40, 50], max_new_tokens=12,
                          temperature=0.7)])
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    done = eng.run_to_completion()
    assert {r.uid: r.output for r in done} == want
    _no_near_tie(m, p, done[0], 0.7, 5)


def test_mixed_greedy_and_temperature_rows_match_reference(models):
    """One engine run mixing greedy rows and rows at two temperatures,
    under a pool small enough to preempt: ids equal the reference's."""
    jm, jp, m, p = models
    temps = [0.0, 0.7, 1.3, 0.0, 0.7]
    prompts = [[3 + i, 17, 29 + i, 41, 50 + 2 * i, 61] for i in range(5)]
    kw = dict(max_batch=3, max_len=32, prefill_chunk=4, page_size=8, total_pages=5,
              rng_seed=11)
    eng = ServeEngine(m, p, device="cpu", cache_mode="paged", **kw)
    eng.submit([Request(uid=f"r{i}", prompt=pr, max_new_tokens=8, temperature=t)
                for i, (pr, t) in enumerate(zip(prompts, temps))])
    jeng = JEngine(jm, jp, cache_mode="paged", **kw)
    jeng.submit([JRequest(uid=f"r{i}", prompt=pr, max_new_tokens=8, temperature=t)
                 for i, (pr, t) in enumerate(zip(prompts, temps))])
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    done = eng.run_to_completion()
    assert {r.uid: r.output for r in done} == want
    assert eng.preemptions == jeng.preemptions > 0
    for r in done:
        if r.temperature > 0:
            _no_near_tie(m, p, r, r.temperature, 11)
