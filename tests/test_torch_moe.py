"""The MoE family (``mixtral-8x7b``: 8 experts, top-2, a 4096-token
sliding window) in the port, plain path on the CPU, against the reference
package on identical numpy inputs at ``reduced()`` size (4 experts of
width 64, top-2, window 32).

Held: the config field for field (full and reduced, and with a shared
expert and a dense first layer as overrides); ``route`` and every
strategy of ``apply_moe`` (``dense``, ``capacity``, ``capacity_scatter``,
``shardmap``) in f32 (atol 1e-5) and bf16 (2e-2), with and without
dropped entries and with the last expert overflowing (the scatter path's
last-write-wins slot); ties among the router's probabilities, lower
expert first as ``lax.top_k``; the model's forward and loss for each
strategy (1e-4); the full-width tree against ``jax.eval_shape``
of the reference's init (46,709,084,160 parameters); the weight bridge
both ways, ``dense_layers`` and the float32 router included; the rolling
sliding-window cache's decode across its wrap; and ``gqa_attention``'s
window mask.  Every gradient against ``jax.grad`` is in
``test_torch_grads.py``."""

import dataclasses

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
from repro.models import moe as jmoe
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model, ModelRuntime, moe
from repro_torch.models.layers import gqa_attention
from repro_torch.models.weights import params_from_jax, params_to_jax, to_reference_layout
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

ARCH = "mixtral-8x7b"
TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STRATEGIES = ("dense", "capacity", "capacity_scatter", "shardmap")
VARIANTS = {"base": {}, "shared_dense": {"n_shared_experts": 1, "first_k_dense": 1}}
FULL_PARAMETERS = 46_709_084_160  # jax.eval_shape of the reference's init at full width


def jcfg(**overrides):
    return jreduced(jget_arch(ARCH), **overrides)


def tcfg(**overrides):
    return reduced(get_arch(ARCH), **overrides)


def test_config_matches_reference():
    assert dataclasses.asdict(get_arch(ARCH)) == dataclasses.asdict(jget_arch(ARCH))
    for overrides in VARIANTS.values():
        assert dataclasses.asdict(tcfg(**overrides)) == dataclasses.asdict(jcfg(**overrides))
    small = tcfg()
    assert (small.n_experts, small.top_k, small.moe_d_ff, small.sliding_window) == (4, 2, 64, 32)
    with pytest.raises(ValueError, match="moe_strategy"):
        ModelRuntime(moe_strategy="experts")


# ------------------------------------------------------------- the MoE layer
def layer_inputs(case: str, dtype: str, shared: bool, seed: int = 0):
    """One MoE layer's numpy weights (the reference's shapes and scales) and
    tokens ``(2, t/2, d)``: ``nodrop`` (capacity factor 2: no expert can
    overflow), ``drops`` (16 tokens at 1.25) or ``overflow_last`` (every
    token prefers the last expert, which overflows)."""
    cfg_kw = dict(n_shared_experts=1 if shared else 0)
    if case == "nodrop":
        cfg_kw["capacity_factor"] = 2.0
    jc, tc = jcfg(**cfg_kw), tcfg(**cfg_kw)
    d, f, e = jc.d_model, jc.moe_d_ff, jc.n_experts
    rng = np.random.default_rng(seed)

    def normal(*shape):  # std 1/sqrt(fan-in), float32
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    w = {"router": normal(d, e), "wi": normal(e, d, f), "wg": normal(e, d, f),
         "wo": normal(e, f, d)}
    if shared:
        w["shared"] = {"wi": normal(d, f), "wg": normal(d, f), "wo": normal(f, d)}
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    if case == "overflow_last":
        x = np.abs(x)
        w["router"][:, e - 1] += 1.0
    jdt, tdt = DTYPES[dtype]
    jw = jax.tree.map(lambda a: jnp.asarray(a, jdt), w)
    jw["router"] = jnp.asarray(w["router"])
    tw = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), w)
    tw["router"] = torch.from_numpy(w["router"])
    return jc, tc, jw, tw, jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def overflowing_experts(ids: torch.Tensor, cfg) -> list:
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    return [i for i, c in enumerate(counts.tolist()) if c > moe.capacity(ids.shape[0], cfg)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["nodrop", "drops", "overflow_last"])
def test_route_matches_reference(case, dtype):
    jc, tc, jw, tw, jx, tx = layer_inputs(case, dtype, shared=False)
    jg, jids = jmoe.route(jw, jx.reshape(-1, jc.d_model), jc.top_k)
    tg, tids = moe.route(tw, tx.reshape(-1, tc.d_model), tc.top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    assert tg.dtype == torch.float32
    want = {"nodrop": [], "drops": "some", "overflow_last": [tc.n_experts - 1]}[case]
    got = overflowing_experts(tids, tc)
    assert got if want == "some" else got == want


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared_expert"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["nodrop", "drops", "overflow_last"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_reference(strategy, case, dtype, shared):
    jc, tc, jw, tw, jx, tx = layer_inputs(case, dtype, shared)
    want = np.asarray(jmoe.apply_moe(jw, jx, jc, strategy).astype(jnp.float32))
    got = moe.apply_moe(tw, tx, tc, strategy)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), want, **MOE_TOL[dtype])


def test_scatter_path_zeroes_the_last_experts_last_kept_slot():
    """The reference's scatter writes the dropped entries' zeros into slot
    ``(E-1, C-1)`` after the kept entry there; the port reproduces it, so
    the two capacity paths differ exactly on that entry's token."""
    jc, tc, jw, tw, jx, tx = layer_inputs("overflow_last", "float32", shared=False)
    gather = moe.apply_moe(tw, tx, tc, "capacity").reshape(-1, tc.d_model)
    scatter = moe.apply_moe(tw, tx, tc, "capacity_scatter").reshape(-1, tc.d_model)
    _, ids = moe.route(tw, tx.reshape(-1, tc.d_model), tc.top_k)
    order, sorted_ids, sorted_tok, pos = moe._rank(ids)
    cap = moe.capacity(ids.shape[0], tc)
    victim = int(sorted_tok[(sorted_ids == tc.n_experts - 1) & (pos == cap - 1)])
    differs = (gather - scatter).abs().amax(dim=-1) > 1e-6
    assert differs.nonzero()[:, 0].tolist() == [victim]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_router_ties_take_the_lower_expert_first(dtype):
    """Equal probabilities (a zero router, a zero hidden row, and two
    identical router columns) pick experts as ``lax.top_k`` does."""
    jc, tc, jw, tw, jx, tx = layer_inputs("drops", dtype, shared=False)
    xt = tx.reshape(-1, tc.d_model).clone()
    xt[3] = 0  # RMSNorm of a zero row, then 0 @ router: every expert ties
    router = tw["router"].clone()
    router[:, 2] = router[:, 0]  # experts 0 and 2 tie on every token
    cases = {"zero_router": torch.zeros_like(router), "tied_columns": router}
    for name, r in cases.items():
        tg, tids = moe.route({"router": r}, xt, tc.top_k)
        jg, jids = jmoe.route({"router": jnp.asarray(r.numpy())},
                              jnp.asarray(xt.float().numpy(), DTYPES[dtype][0]), jc.top_k)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids), err_msg=name)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, err_msg=name)
    assert moe.route({"router": torch.zeros_like(router)}, xt, 2)[1].tolist()[0] == [0, 1]
    assert moe.route({"router": router}, xt, 2)[1][3].tolist() == [0, 1]  # the zero row


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def models():
    """variant -> (jax model, jax params, port config, port params)."""
    out = {}
    for name, overrides in VARIANTS.items():
        jm = JModel(jcfg(**overrides), JRuntime(attn_impl="direct"))
        jp = jm.init(jax.random.PRNGKey(0))
        out[name] = (jm, jp, tcfg(**overrides),
                     params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("strategy", ["dense", "capacity", "capacity_scatter"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_loss_match_reference(models, variant, strategy):
    jm, jp, cfg, p = models[variant]
    jm = JModel(jm.cfg, JRuntime(attn_impl="direct", moe_strategy=strategy))
    m = Model(cfg, ModelRuntime(attn_impl="direct", moe_strategy=strategy))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48))  # past the window
    want = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    np.testing.assert_allclose(m.forward(p, torch.from_numpy(toks)).numpy(), want, **TOL)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = m.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layer_tree_and_bridge_round_trip(models, variant):
    jm, jp, cfg, p = models[variant]
    np_params = jax.tree.map(np.asarray, jp)
    back = params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    n_dense = cfg.first_k_dense
    assert ["mlp" in layer for layer in p["layers"]] == [i < n_dense for i in range(cfg.n_layers)]
    assert all(("shared" in layer["moe"]) == bool(cfg.n_shared_experts)
               for layer in p["layers"][n_dense:])
    assert ("dense_layers" in np_params) == bool(n_dense)
    # the port's own init builds the same tree; in bf16 the router stays float32
    for dtype in (torch.float32, torch.bfloat16):
        own = Model(cfg, ModelRuntime(dtype=dtype)).init(0, device="cpu")
        bridged = params_from_jax(np_params, device="cpu", dtype=dtype)
        sig = [(path, tuple(t.shape), t.dtype) for path, t in tree_leaves_with_path(own)]
        assert sig == [(path, tuple(t.shape), t.dtype)
                       for path, t in tree_leaves_with_path(bridged)]
        assert all((t.dtype == torch.float32) == (dtype == torch.float32 or path[-1] == "router")
                   for path, t in tree_leaves_with_path(own))
        drawn = Model(cfg, ModelRuntime(dtype=dtype)).draw(torch.Generator("cpu").manual_seed(0))
        assert sig == [(path, tuple(t.shape), t.dtype)
                       for path, t in tree_leaves_with_path(drawn)]


def test_full_width_tree_matches_eval_shape():
    """``abstract_params`` (meta tensors) against ``jax.eval_shape`` of the
    reference's init at full width, nothing allocated."""
    jm = JModel(jget_arch(ARCH))
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    got = to_reference_layout(Model(get_arch(ARCH)).abstract_params())
    flat_want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                 for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {}
    tree_map_with_path(lambda path, t: flat_got.setdefault(
        "".join(f"[{k!r}]" for k in path), (tuple(t.shape), str(t.dtype).split(".")[-1])), got)
    assert flat_got == flat_want
    assert sum(int(np.prod(s)) for s, _ in flat_got.values()) == FULL_PARAMETERS
    assert flat_got["['layers']['moe']['wi']"][0] == (32, 8, 4096, 14336)
    assert flat_got["['layers']['moe']['router']"][1] == "float32"


# ------------------------------------------------------------- the rolling cache
def test_gqa_attention_window_matches_reference():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    qp = np.asarray([[37, 38, 39], [10, 11, 12]])
    kp = np.tile(np.arange(40), (2, 1))
    mask = kp < 39
    for window in (0, 8, 32):
        want = jlayers.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp),
                                     sliding_window=window, kv_mask=jnp.asarray(mask))
        got = gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            q_positions=torch.from_numpy(qp), kv_positions=torch.from_numpy(kp),
                            sliding_window=window, kv_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strategy", ["dense", "capacity"])
def test_rolling_cache_decode_across_the_wrap_matches_reference(models, strategy):
    """Window 32 at ``max_len`` 256: 128 rolling slots.  Both caches start
    from the same random contents, rows at positions 125 and 300 (already
    wrapped) decode 5 steps: logits and every slot at 1e-4."""
    jm, jp, cfg, p = models["base"]
    jm = JModel(jm.cfg, JRuntime(moe_strategy=strategy))
    m = Model(cfg, ModelRuntime(moe_strategy=strategy))
    jc = jm.init_cache(2, 256)
    tc = m.init_cache(2, 256, device="cpu")
    assert tc["k"].shape == tuple(jc["k"].shape) == (cfg.n_layers, 2, 128, 2, 16)
    assert m.init_cache(2, 96, device="cpu")["k"].shape[2] == 96  # shorter than the window pad
    rng = np.random.default_rng(7)
    for name in ("k", "v"):
        fill = rng.standard_normal(tc[name].shape).astype(np.float32)
        jc[name] = jnp.asarray(fill)
        tc[name].copy_(torch.from_numpy(fill))
    pos = np.asarray([125, 300], np.int32)
    for _ in range(5):
        nxt = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(nxt).long(), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)
