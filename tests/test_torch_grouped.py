"""Grouped dispatch (``dispatch_mode="grouped"``: one decode dispatch per
distinct row position, prompts ingested through the decode path) in the
port, plain path on the CPU, against the reference's grouped engine on
shared weights: the ragged and preemption workloads of
``test_torch_serving.py`` on the paged cache, and the dense cache's
refill workload, with greedy and temperature rows: tokens and every
counter equal, the allocator invariants checked after every tick, and
tokens equal to the fused engine's."""

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
from test_torch_serving import WORKLOADS as PAGED_WORKLOADS
from test_torch_serving_dense import BASE as DENSE_BASE
from test_torch_serving_dense import COUNTERS as DENSE_COUNTERS
from test_torch_serving_dense import PROMPTS as DENSE_PROMPTS

torch.set_num_threads(1)  # the test workers share the host's cores

WORKLOADS = {
    "paged_ragged": (PAGED_WORKLOADS["ragged"], PAGED_COUNTERS),
    "paged_preemption": (PAGED_WORKLOADS["preemption"], PAGED_COUNTERS),
    "dense_refill": (([[(f"r{i}", p, 4) for i, p in enumerate(DENSE_PROMPTS)]], DENSE_BASE),
                     DENSE_COUNTERS),
}


@pytest.fixture(scope="module")
def models():
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(reduced(get_arch("ds-paper-100m")))
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def run(engine, cls, batches, temperature, check=False):
    for batch in batches:
        engine.submit([cls(uid=u, prompt=list(p), max_new_tokens=n,
                           temperature=temperature if i % 2 else 0.0)
                       for i, (u, p, n) in enumerate(batch)])
        while engine.pending or engine.scheduler.has_active():
            engine.step()
            if check:
                engine.cache_mgr.check_invariants()
    return {r.uid: r.output for r in engine.finished}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_grouped_engine_matches_reference(models, workload, temperature):
    jm, jp, m, p = models
    (batches, kw), counters = WORKLOADS[workload]
    kw = dict(kw, dispatch_mode="grouped", rng_seed=3)
    jeng = JEngine(jm, jp, **kw)
    want = run(jeng, JRequest, batches, temperature)
    eng = ServeEngine(m, p, device="cpu", **kw)
    assert not eng._use_prefill and eng._use_prefill == jeng._use_prefill
    got = run(eng, Request, batches, temperature, check=True)
    assert got == want
    for name in counters:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.stats.snapshot() == jeng.stats.snapshot()
    assert eng.snapshot()["timing"] == jeng.snapshot()["timing"]
    assert eng.prefill_dispatches == 0
    # rows at different positions take a dispatch each
    assert eng.decode_dispatches > eng.scheduler.tick
    fused = ServeEngine(m, p, device="cpu", **dict(kw, dispatch_mode="fused"))
    assert run(fused, Request, batches, temperature) == got
    assert fused.dispatches < eng.dispatches
