"""The speculative verify dispatch and the n-gram proposer in the port
(plain path on the CPU) against the reference on identical numpy inputs:
``Model.verify_chunk``'s logits at every valid position (paged and dense,
ragged lengths with a parked row, page-crossing offsets) within 1e-5 in
f32; ``make_verify_step``'s targets, emit counts and done flags equal on
greedy and temperature rows, with an accepted run cut by a rejection, a
stop token and a new-token budget; the paged kernel's plain version at
ds-paper-100m's verify folds (G 1 x T 5 and 7 on the decode path, T 9 on
the CUDA-core path) against the reference's kernel in interpret mode and
its oracle; and ``NgramProposer``'s proposals equal on seeded histories,
extending and not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving.sampling import make_verify_step as jmake_verify_step
from repro.serving.speculate import NgramProposer as JNgram
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.sampling import make_verify_step
from repro_torch.kernels import flash_decode
from repro_torch.serving.speculate import NgramProposer
from test_torch_kernels import _paged_case, _run_both, f32, tol

torch.set_num_threads(1)  # the test workers share the host's cores

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(reduced(get_arch("ds-paper-100m")))
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# ------------------------------------------------------------ verify dispatch
def _verify_inputs(m, T, rng):
    """Inputs of one verify dispatch after a ragged prefill: row 0 from 0,
    row 1 crossing a page (offset 6, page 8), row 2 at a page boundary,
    row 3 parked (length 0)."""
    B, ps = 4, 8
    pre = np.asarray([6, 6, 8, 0], np.int64)
    lengths = np.asarray([T, 3, T, 0], np.int64)
    prompt = rng.integers(1, m.cfg.vocab_size, (B, 8)).astype(np.int64)
    drafts = rng.integers(1, m.cfg.vocab_size, (B, T)).astype(np.int64)
    drafts[np.arange(T)[None, :] >= lengths[:, None]] = 0
    return B, ps, pre, prompt, drafts, lengths


def _fresh_caches(jm, m, B, ps, cache_mode):
    max_len, n_pages = 32, 16
    if cache_mode == "dense":
        return jm.init_cache(B, max_len), m.init_cache(B, max_len, device="cpu")
    table = np.full((B, max_len // ps), n_pages, np.int32)
    table[0, :2] = [3, 0]
    table[1, :3] = [5, 9, 1]
    table[2, :3] = [7, 2, 11]  # row 3 parked
    jc = jm.init_cache(B, max_len, paged=True, page_size=ps, n_pages=n_pages)
    jc["page_table"] = jnp.asarray(table)
    tc = m.init_cache(B, max_len, paged=True, page_size=ps, n_pages=n_pages, device="cpu")
    tc["page_table"].copy_(torch.from_numpy(table))
    return jc, tc


@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
def test_verify_chunk_and_step_match_reference(models, cache_mode):
    jm, jp, m, p = models
    T = 5
    rng = np.random.default_rng(3)
    B, ps, pre, prompt, drafts, lengths = _verify_inputs(m, T, rng)

    # verify_chunk: every valid position's logits
    jc, tc = _fresh_caches(jm, m, B, ps, cache_mode)
    _, jc = jm.prefill_chunk(jp, jc, jnp.asarray(prompt, jnp.int32), jnp.zeros(B, jnp.int32),
                             jnp.asarray(pre, jnp.int32))
    m.prefill_chunk(p, tc, torch.from_numpy(prompt), torch.zeros(B, dtype=torch.long),
                    torch.from_numpy(pre))
    jl, _ = jm.verify_chunk(jp, jc, jnp.asarray(drafts, jnp.int32), jnp.asarray(pre, jnp.int32),
                            jnp.asarray(lengths, jnp.int32))
    tl, _ = m.verify_chunk(p, tc, torch.from_numpy(drafts), torch.from_numpy(pre),
                           torch.from_numpy(lengths))
    assert tl.shape == (B, T, m.cfg.padded_vocab)
    valid = np.arange(T)[None, :] < lengths[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **LOGIT_TOL)

    # make_verify_step: drafts built from the targets so runs of several
    # accepted tokens occur, then cut at a different position each row;
    # greedy and temperature rows, a stop token and a new-token budget
    temps = np.asarray([0.0, 0.9, 0.6, 0.0], np.float32)
    streams = np.asarray([0, 1, 2, 3], np.int64)
    steps = np.asarray([0, 3, 1, 0], np.int64)
    max_news = np.asarray([100, 100, 4, 100], np.int64)
    jstep, tstep = jmake_verify_step(jm, 5), make_verify_step(m, 5)
    tokens = drafts.copy()
    stops = np.full(B, -1, np.int64)

    def both(tokens, stops):
        jc, tc = _fresh_caches(jm, m, B, ps, cache_mode)
        jm_out = jstep(jp, jm.prefill_chunk(jp, jc, jnp.asarray(prompt, jnp.int32),
                                            jnp.zeros(B, jnp.int32),
                                            jnp.asarray(pre, jnp.int32))[1],
                       *(jnp.asarray(a, jnp.int32) for a in (tokens, pre, lengths)),
                       jnp.asarray(temps), *(jnp.asarray(a, jnp.int32)
                                             for a in (streams, steps, stops, max_news)))
        m.prefill_chunk(p, tc, torch.from_numpy(prompt), torch.zeros(B, dtype=torch.long),
                        torch.from_numpy(pre))
        t_out = tstep(p, tc, tokens, pre, lengths, temps, streams, steps, stops, max_news)
        return [np.asarray(a) for a in jm_out[:3]], [a.numpy() for a in t_out[:3]]

    for t in range(1, T):  # draft t := the target at t - 1 (a consistent chain)
        (jtgt, _, _), _ = both(tokens, stops)
        tokens[:, t] = np.where(t < lengths, jtgt[:, t - 1], 0)
    tokens[0, 3] = (tokens[0, 3] + 1) % m.cfg.vocab_size  # row 0 rejects its third draft
    (jtgt, _, _), _ = both(tokens, stops)
    stops[1] = jtgt[1, 1]  # row 1 stops on its second target
    (jtgt, jn, jdone), (ttgt, tn, tdone) = both(tokens, stops)
    np.testing.assert_array_equal(ttgt[valid], jtgt[valid])
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tdone, jdone)
    assert list(tn) == [3, 2, 3, 0]  # rejection, stop, budget, parked
    assert list(tdone) == [False, True, True, False]


# ------------------------------------------------------------------ proposer
def test_ngram_proposer_matches_reference():
    """Identical proposals on seeded random histories: histories that
    extend the last one (incremental tables), and ones that do not
    (rebuilds), across rows and draft lengths."""
    rng = np.random.default_rng(0)
    mine, theirs = NgramProposer(), JNgram()
    hists = {r: rng.integers(1, 6, rng.integers(1, 12)).tolist() for r in range(3)}
    for it in range(40):
        k = int(rng.integers(1, 9))
        for r in hists:
            if rng.random() < 0.2:  # not an extension: preemption, slot reuse
                hists[r] = rng.integers(1, 6, rng.integers(1, 12)).tolist()
            else:
                hists[r] = hists[r] + rng.integers(1, 6, rng.integers(0, 4)).tolist()
        rows = sorted(rng.choice(3, int(rng.integers(1, 4)), replace=False).tolist())
        got = mine.propose(rows, hists, k)
        assert got == theirs.propose(rows, hists, k), f"iteration {it}"
        assert all(len(d) <= k for d in got.values())
        if it % 7 == 6:
            mine.release(rows[0])
            theirs.release(rows[0])


# ------------------------------------------------------------ the paged kernel
# The verify dispatch of ds-paper-100m (G 1) folds T = spec_k + 1 rows: the
# decode path up to spec_k 7, from spec_k 8 the tensor-core path (f32 in
# 3xTF32); rows from 0, crossing a page and at a page boundary.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,ps,path", [(7, 16, "decode"), (9, 8, "tensor_core"),
                                       (9, 16, "tensor_core")])
def test_paged_attention_at_verify_shapes_vs_reference(T, ps, path, dtype):
    hkv = 2
    case = _paged_case(B=3, T=T, hkv=hkv, g=1, dk=64, ps=ps, P=128 // ps,
                       n_pages=3 * 128 // ps + 2, offsets=[0, ps + 3, 2 * ps], seed=ps + T)
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    assert flash_decode.kernel_path(tdtype, T, 64, 64) == path
    got, want_kernel, want_ref, port_ref = _run_both(*case, dtype=dtype)
    assert got.shape == (3, T, hkv, 64)
    for want in (want_kernel, want_ref, port_ref):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
