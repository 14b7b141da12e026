"""Port model (plain path on the CPU) against the reference JAX model on
shared weights: the weight bridge, the layer primitives, paged
``decode_step``/``prefill_chunk`` logits at valid positions (f32,
atol/rtol 1e-4), and masked cache writes (parked rows and padded tokens
write no page, page 0 included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.models import layers as jlayers
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model, layers
from repro_torch.models.weights import params_from_jax

torch.set_num_threads(1)  # the test workers share the host's cores

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def shared():
    """(jax model, jax params, port model, port params) on one weight set."""
    jm = JModel(jreduced(jget_arch("ds-paper-100m")), JRuntime(paged_attn_impl="jnp"))
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(reduced(get_arch("ds-paper-100m")))
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_reduced_config_matches_reference():
    import dataclasses

    mine = dataclasses.asdict(reduced(get_arch("ds-paper-100m")))
    theirs = dataclasses.asdict(jreduced(jget_arch("ds-paper-100m")))
    assert mine == theirs
    full_mine = dataclasses.asdict(get_arch("ds-paper-100m"))
    assert full_mine == dataclasses.asdict(jget_arch("ds-paper-100m"))


def test_params_from_jax_round_trip(shared):
    jm, jp, m, p = shared
    np_params = jax.tree.map(np.asarray, jp)
    L = m.cfg.n_layers
    assert len(p["layers"]) == L
    for i in range(L):
        flat_port = jax.tree_util.tree_leaves_with_path(p["layers"][i])
        for path, leaf in flat_port:
            node = np_params["layers"]
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(leaf.numpy(), node[i])
    for name in ("embed", "lm_head"):
        np.testing.assert_array_equal(p[name].numpy(), np_params[name])
    np.testing.assert_array_equal(p["ln_f"]["w"].numpy(), np_params["ln_f"]["w"])
    # the numpy-seeded init builds the same tree shape as the bridge
    own = m.init(0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == jax.tree.map(
        lambda t: tuple(t.shape), p)


# ------------------------------------------------------------- primitives
def test_layer_primitives_match_reference():
    rng = np.random.default_rng(0)
    b, s, h, hkv, hd, d, f = 2, 5, 4, 2, 16, 64, 128
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.asarray([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    t = torch.from_numpy
    # norms
    w = (rng.standard_normal(d) + 1).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    for kind, jp_, tp_ in (("rmsnorm", {"w": w}, {"w": t(w)}),
                           ("layernorm", {"w": w, "b": bias}, {"w": t(w), "b": t(bias)})):
        want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in jp_.items()},
                                  jnp.asarray(x), kind, 1e-5)
        np.testing.assert_allclose(layers.apply_norm(tp_, t(x), kind, 1e-5).numpy(),
                                   np.asarray(want), rtol=2e-5, atol=2e-5)
    # rope (half-split, f32 angles)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    np.testing.assert_allclose(
        layers.apply_rope(t(q), t(pos), 10_000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10_000.0)),
        rtol=2e-5, atol=2e-5)
    # mlp, every activation
    mp = {k: rng.standard_normal(shape).astype(np.float32) * 0.1
          for k, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    for act in ("silu", "gelu_gated", "gelu", "relu2"):
        want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in mp.items()}, jnp.asarray(x), act)
        got = layers.apply_mlp({k: t(v) for k, v in mp.items()}, t(x), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # qkv projection + grouped attention over a contiguous cache
    ap = {k: rng.standard_normal(shape).astype(np.float32) * 0.1
          for k, shape in (("wq", (d, h * hd)), ("wk", (d, hkv * hd)), ("wv", (d, hkv * hd)))}
    jq, jk, jv = jlayers.qkv_project({k: jnp.asarray(v) for k, v in ap.items()},
                                     jnp.asarray(x), h, hkv, hd)
    tq, tk, tv = layers.qkv_project({k: t(v) for k, v in ap.items()}, t(x), h, hkv, hd)
    for a, bb in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), **TOL)
    kv_pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kv_pos[1] += 2  # row 1's first queries see part of the cache
    want = jlayers.gqa_attention(jq, jk, jv, q_positions=jnp.asarray(pos),
                                 kv_positions=jnp.asarray(kv_pos))
    got = layers.gqa_attention(tq, tk, tv, q_positions=t(pos), kv_positions=t(kv_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(layers.repeat_kv(tk, h).numpy(),
                               np.asarray(jlayers.repeat_kv(jk, h)))


# ------------------------------------------------------------- dispatches
def _caches(jm, m, B, max_len, ps, n_pages, table):
    jc = jm.init_cache(B, max_len, paged=True, page_size=ps, n_pages=n_pages)
    jc["page_table"] = jnp.asarray(table)
    tc = m.init_cache(B, max_len, paged=True, page_size=ps, n_pages=n_pages, device="cpu")
    tc["page_table"].copy_(torch.from_numpy(table))
    return jc, tc


def test_prefill_then_decode_logits_match_reference(shared):
    """Ragged chunked prefill (a padded row, a row resuming mid-page, an
    inactive row) then several ragged decode steps with a parked row:
    logits at valid positions and the written pages agree with the JAX
    model at 1e-4."""
    jm, jp, m, p = shared
    B, max_len, ps, n_pages = 4, 32, 8, 12
    table = np.full((B, max_len // ps), n_pages, np.int32)
    table[0, :2] = [3, 0]
    table[1, :2] = [5, 9]
    table[2, :1] = [7]  # row 3 stays parked (all sentinel)
    jc, tc = _caches(jm, m, B, max_len, ps, n_pages, table)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, 256, (B, 6)).astype(np.int32)
    offs = np.asarray([0, 5, 0, 0], np.int32)
    lens = np.asarray([6, 4, 3, 0], np.int32)
    jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks), jnp.asarray(offs), jnp.asarray(lens))
    tl, tc = m.prefill_chunk(p, tc, torch.from_numpy(toks).long(), torch.from_numpy(offs),
                             torch.from_numpy(lens))
    live = lens > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
    pos = offs + lens
    for _ in range(3):
        nxt = rng.integers(1, 256, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(nxt).long(), torch.from_numpy(pos))
        assert tl.shape == (B, 1, m.cfg.padded_vocab)
        np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], **TOL)
        pos = pos + 1
    used = sorted({int(x) for x in table.ravel() if x < n_pages})
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tc[name].numpy()[:, used], np.asarray(jc[name])[:, used],
                                   **TOL)


@pytest.mark.parametrize("positions", ["uniform", "ragged"])
def test_decode_step_builder_matches_reference(shared, positions):
    """``train.steps.make_decode_step`` against the reference's on the
    dense cache: three decode steps from empty caches, logits at 1e-4."""
    from repro.train.steps import make_decode_step as jmake_decode_step
    from repro_torch.train.steps import make_decode_step

    jm, jp, m, p = shared
    jstep, tstep = jmake_decode_step(jm), make_decode_step(m)
    b, max_len = 3, 16
    jc, tc = jm.init_cache(b, max_len), m.init_cache(b, max_len, device="cpu")
    rng = np.random.default_rng(5)
    pos = np.zeros(b, np.int32) if positions == "uniform" else np.asarray([0, 3, 7], np.int32)
    for _ in range(3):
        nxt = rng.integers(1, 256, (b, 1)).astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = tstep(p, tc, torch.from_numpy(nxt).long(), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1


def test_parked_and_padded_rows_write_no_page(shared):
    """JAX drops out-of-bounds scatters; the port masks them.  A parked
    row (sentinel table) and padded prefill tokens must leave every page,
    page 0 included, untouched; only the real tokens' slots change."""
    jm, jp, m, p = shared
    B, max_len, ps, n_pages = 3, 32, 8, 6
    table = np.full((B, max_len // ps), n_pages, np.int32)
    table[0, 0] = 1  # row 0 live on page 1; rows 1 and 2 parked
    _, tc = _caches(jm, m, B, max_len, ps, n_pages, table)
    for name in ("k_pages", "v_pages"):
        tc[name].fill_(7.0)
    toks = torch.tensor([[5, 6, 7, 8], [1, 2, 3, 4], [9, 9, 9, 9]])
    m.prefill_chunk(p, tc, toks, torch.tensor([2, 0, 30]), torch.tensor([2, 4, 0]))
    m.decode_step(p, tc, torch.tensor([[3], [4], [5]]), torch.tensor([4, 0, 31]))
    for name in ("k_pages", "v_pages"):
        pages = tc[name]
        changed = (pages != 7.0).any(dim=(3, 4))  # (L, n_pages, ps)
        want = torch.zeros_like(changed)
        want[:, 1, 2:5] = True  # row 0: two prefill tokens at 2, 3 and the decode at 4
        assert torch.equal(changed, want), name


def test_decode_step_accepts_scalar_position(shared):
    jm, jp, m, p = shared
    B, max_len, ps, n_pages = 2, 16, 8, 4
    table = np.asarray([[0, 1], [2, 3]], np.int32)
    _, tc = _caches(jm, m, B, max_len, ps, n_pages, table)
    _, tc2 = _caches(jm, m, B, max_len, ps, n_pages, table)
    a, _ = m.decode_step(p, tc, torch.tensor([[3], [4]]), torch.tensor(0))
    b, _ = m.decode_step(p, tc2, torch.tensor([[3], [4]]), torch.tensor([0, 0]))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
