"""Multi-head Latent Attention and ``deepseek-v2-236b`` (MLA over the
160-expert MoE) in the port, plain path on the CPU, against the reference
package on identical numpy inputs at ``reduced()`` size (latent rank 32,
queries 48, RoPE keys of 8, no-RoPE and value heads of 16; 4 experts, one
shared, a dense first layer).

Held: the config field for field (full and reduced); every function of
``models/mla.py`` against ``repro.models.mla`` in f32 (1e-5) and bf16
(2e-2): the query and latent projections, ``apply_mla``, the dense
cache's ``apply_mla_extend`` (ragged ``valid``) and ``apply_mla_decode``
(uniform and per-row positions), ``apply_mla_paged`` at T 1 and T 3 with
a parked row, an unallocated page inside a row's span and padded tokens,
against both reference routes (jnp, and the Pallas kernel in interpret
mode); the model's forward and loss under ``dense`` and ``capacity``
(1e-4); ``prefill_chunk`` and ``verify_chunk`` of a dense-family MLA
variant on the paged and the dense cache (1e-5); the weight bridge both
ways; the full-width tree against ``jax.eval_shape`` of the reference's
init (235,741,434,880 parameters); and ``Model.draw``'s MLA leaves
(dtypes, and each leaf's std within 2% of its init scale)."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.models import mla as jmla
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model, ModelRuntime, mla
from repro_torch.models.transformer import write_slots
from repro_torch.models.weights import params_from_jax, params_to_jax, to_reference_layout
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

ARCH = "deepseek-v2-236b"
TOL = dict(rtol=1e-4, atol=1e-4)
FN_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FULL_PARAMETERS = 235_741_434_880  # jax.eval_shape of the reference's init at full width
MLA_LEAVES = ("q_down", "q_norm", "q_up", "kv_down", "kv_norm", "k_up", "v_up", "wo")


def jcfg(**overrides):
    return jreduced(jget_arch(ARCH), **overrides)


def tcfg(**overrides):
    return reduced(get_arch(ARCH), **overrides)


def test_config_matches_reference():
    assert dataclasses.asdict(get_arch(ARCH)) == dataclasses.asdict(jget_arch(ARCH))
    assert dataclasses.asdict(tcfg()) == dataclasses.asdict(jcfg())
    assert dataclasses.asdict(tcfg(family="dense")) == dataclasses.asdict(jcfg(family="dense"))
    small = tcfg()
    assert (small.kv_lora_rank, small.q_lora_rank, small.rope_head_dim, small.nope_head_dim,
            small.v_head_dim, small.head_dim) == (32, 48, 8, 16, 16, 0)
    assert mla.mla_page_width(small) == jmla.mla_page_width(jcfg()) == 40
    assert mla.mla_page_width(get_arch(ARCH)) == 576


# ------------------------------------------------------------- the MLA layer
def layer(dtype: str, seed: int = 0):
    """One MLA layer's weights from the reference's ``mla_init`` (norm
    weights drawn away from 1 so they count), in both packages' dtype."""
    jc, tc = jcfg(), tcfg()
    w = jax.tree.map(np.asarray, jmla.mla_init(jax.random.PRNGKey(seed), jc, jnp.float32, 0.5))
    rng = np.random.default_rng(seed)
    for name in ("q_norm", "kv_norm"):
        w[name]["w"] = (1.0 + 0.3 * rng.standard_normal(w[name]["w"].shape)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return (jc, tc, jax.tree.map(lambda a: jnp.asarray(a, jdt), w),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(tdt), w))


def inputs(shape, dtype: str, seed: int):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def ref(fn, *args, **kw):
    """A reference function jitted, its config and flags static: one compile
    where eager JAX compiles each primitive (the tolerances absorb the
    fused rounding)."""
    static = {k: v for k, v in kw.items() if not isinstance(v, jax.Array)}
    arrays = {k: v for k, v in kw.items() if isinstance(v, jax.Array)}
    return jax.jit(functools.partial(fn, **static))(*args, **arrays)


def close(got: torch.Tensor, want, dtype: str, what: str = ""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               err_msg=what, **FN_TOL[dtype])


def test_param_tree_matches_mla_init():
    jc, tc = jcfg(), tcfg()
    want = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda k: jmla.mla_init(k, jc, jnp.float32, 0.5), jax.random.PRNGKey(0)))

    def dense(d_in, d_out, scale=1.0):
        return torch.empty((d_in, d_out))

    got = mla.mla_param_tree(tc, dense, lambda w: {"w": torch.empty((w,))}, 0.5)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want
    assert sorted(got) == sorted(MLA_LEAVES)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_projections_match_reference(dtype):
    jc, tc, jw, tw = layer(dtype)
    jx, tx = inputs((2, 6, jc.d_model), dtype, 1)
    pos = np.asarray([[0, 1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12]])
    for jf, tf, name in ((jmla._project_q, mla._project_q, "project_q"),
                         (jmla._compress_kv, mla._compress_kv, "compress_kv")):
        want = ref(jf, jw, jx, cfg=jc, positions=jnp.asarray(pos))
        got = tf(tw, tx, tc, torch.from_numpy(pos))
        for a, b in zip(got, want):
            assert a.dtype == tx.dtype and tuple(a.shape) == b.shape
            close(a, b, dtype, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mla_matches_reference(dtype):
    jc, tc, jw, tw = layer(dtype)
    jx, tx = inputs((2, 12, jc.d_model), dtype, 2)
    close(mla.apply_mla(tw, tx, tc), ref(jmla.apply_mla, jw, jx, cfg=jc), dtype,
          "default positions")
    pos = np.tile(np.arange(5, 17), (2, 1))
    close(mla.apply_mla(tw, tx, tc, positions=torch.from_numpy(pos)),
          ref(jmla.apply_mla, jw, jx, cfg=jc, positions=jnp.asarray(pos)), dtype,
          "offset positions")


def dense_caches(dtype: str, b: int, t: int, seed: int):
    """The dense latent cache of both packages, filled with the same
    random contents (a cache a few tokens deep)."""
    jc, tc = jcfg(), tcfg()
    jcache = jmla.mla_decode_cache(jc, b, t, DTYPES[dtype][0])
    tcache = mla.mla_decode_cache(tc, b, t, DTYPES[dtype][1])
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {k: v.shape for k, v in
                                                              jcache.items()}
    assert all(v.dtype == DTYPES[dtype][1] and not v.any() for v in tcache.values())
    for name in jcache:
        ja, ta = inputs(jcache[name].shape, dtype, seed + len(name))
        jcache[name], tcache[name] = ja, ta
    return jcache, tcache


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mla_extend_matches_reference(dtype):
    """Three rows of a 4-token chunk at ragged offsets, the third with two
    padded tokens that write nothing."""
    jc, tc, jw, tw = layer(dtype)
    jcache, tcache = dense_caches(dtype, 3, 24, 3)
    jx, tx = inputs((3, 4, jc.d_model), dtype, 4)
    pos = np.asarray([0, 9, 17])[:, None] + np.arange(4)[None]
    valid = np.asarray([[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 0, 0]], bool)
    jo, jcache = ref(jmla.apply_mla_extend, jw, jx, jcache, jnp.asarray(pos), cfg=jc,
                     valid=jnp.asarray(valid))
    to, tcache = mla.apply_mla_extend(tw, tx, tcache, torch.from_numpy(pos), tc,
                                      torch.from_numpy(valid).nonzero(as_tuple=True))
    close(to, jo, dtype, "out")
    for name in jcache:
        close(tcache[name], jcache[name], dtype, name)


@pytest.mark.parametrize("uniform", [True, False], ids=["scalar_pos", "per_row_pos"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mla_decode_matches_reference(dtype, uniform):
    jc, tc, jw, tw = layer(dtype)
    jcache, tcache = dense_caches(dtype, 3, 24, 5)
    pos = np.asarray(11) if uniform else np.asarray([0, 11, 23])
    for step in range(3):
        jx, tx = inputs((3, 1, jc.d_model), dtype, 6 + step)
        jo, jcache = ref(jmla.apply_mla_decode, jw, jx, jcache, jnp.asarray(pos, jnp.int32),
                         cfg=jc)
        to, tcache = mla.apply_mla_decode(tw, tx, tcache, torch.as_tensor(pos), tc)
        close(to, jo, dtype, f"step {step}")
        pos = np.minimum(pos + 1, 23)
    for name in jcache:
        close(tcache[name], jcache[name], dtype, name)


# ------------------------------------------------------------- the paged path
N_PAGES, PS = 12, 4


def paged_case(dtype: str, T: int):
    """Four rows over a 12-page pool of random contents, 4 pages a row:
    row 0 at offset 5, row 1 parked (sentinel row), row 2 at offset 6 on
    its second page, which is unallocated (masked; the writes there are
    dropped), row 3 at offset 0 with padded tokens when ``T > 1``."""
    table = np.full((4, 4), N_PAGES, np.int32)
    table[0, :3] = [7, 2, 10]
    table[2, :4] = [4, N_PAGES, 0, 9]
    table[3, :2] = [11, 5]
    offsets = np.asarray([5, 3, 6, 0])
    pos = offsets[:, None] + np.arange(T)[None]
    valid = np.ones((4, T), bool)
    valid[3, 1:] = False
    jpages, tpages = inputs((N_PAGES, PS, mla.mla_page_width(tcfg())), dtype, 20 + T)
    return table, pos, valid, jpages, tpages


@pytest.mark.parametrize("impl", ["jnp", "kernel"])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mla_paged_matches_reference(dtype, T, impl):
    """Held against the reference's jnp route and its Pallas kernel in
    interpret mode.  The parked row attends nothing: the kernel's contract
    (and the port's) gives it zeros, the jnp route an average of garbage,
    so against jnp it is left out of the output comparison."""
    jc, tc, jw, tw = layer(dtype)
    table, pos, valid, jpages, tpages = paged_case(dtype, T)
    jx, tx = inputs((4, T, jc.d_model), dtype, 30 + T)
    jo, jpages = ref(jmla.apply_mla_paged, jw, jx, jpages, jnp.asarray(table),
                     jnp.asarray(pos), cfg=jc, impl=impl, valid=jnp.asarray(valid))
    t_table, t_pos = torch.from_numpy(table), torch.from_numpy(pos)
    slots = write_slots(t_table, N_PAGES, PS, t_pos, torch.from_numpy(valid))
    to, tpages = mla.apply_mla_paged(tw, tx, tpages, t_table, t_pos, tc, slots)
    rows = [0, 1, 2, 3] if impl == "kernel" else [0, 2, 3]
    assert to.dtype == tx.dtype and tuple(to.shape) == (4, T, jc.d_model)
    close(to[rows], np.asarray(jnp.asarray(jo, jnp.float32))[rows], dtype, "out")
    close(tpages, jpages, dtype, "pages")
    if impl == "kernel":  # the parked row: exactly the output projection of zeros
        assert not to[1].any()


def test_apply_mla_paged_writes_only_real_tokens_on_backed_pages():
    """The padded token, the parked row and the unallocated page write
    nothing: only the slots ``write_slots`` names change."""
    jc, tc, jw, tw = layer("float32")
    table, pos, valid, _, pages = paged_case("float32", 3)
    _, tx = inputs((4, 3, jc.d_model), "float32", 33)
    t_table, t_pos = torch.from_numpy(table), torch.from_numpy(pos)
    slots = write_slots(t_table, N_PAGES, PS, t_pos, torch.from_numpy(valid))
    assert slots[0].tolist() == [0, 0, 0, 2, 3]  # row 1 parked, 2's page 1 unallocated
    _, written = mla.apply_mla_paged(tw, tx, pages.clone(), t_table, t_pos, tc, slots)
    changed = (written != pages).any(dim=-1).nonzero().tolist()
    assert changed == [[0, 0], [2, 1], [2, 2], [2, 3], [11, 0]]


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def models():
    """family -> (jax model, jax params, port config, port params)."""
    out = {}
    for family in ("moe", "dense"):
        jm = JModel(jcfg(family=family), JRuntime(attn_impl="direct"))
        jp = jm.init(jax.random.PRNGKey(0))
        out[family] = (jm, jp, tcfg(family=family),
                       params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("strategy", ["dense", "capacity"])
def test_forward_and_loss_match_reference(models, strategy):
    jm, jp, cfg, p = models["moe"]
    jm = JModel(jm.cfg, JRuntime(attn_impl="direct", moe_strategy=strategy))
    m = Model(cfg, ModelRuntime(moe_strategy=strategy))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    want = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    np.testing.assert_allclose(m.forward(p, torch.from_numpy(toks)).numpy(), want, **TOL)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = m.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def fresh_caches(jm, m, cache_mode: str, B: int = 4, ps: int = 8):
    max_len, n_pages = 32, 16
    if cache_mode == "dense":
        jc, tc = jm.init_cache(B, max_len), m.init_cache(B, max_len, device="cpu")
        assert set(tc) == {"c_kv", "k_rope"}
        assert tc["c_kv"].shape == tuple(jc["c_kv"].shape) == (2, B, max_len, 32)
        return jc, tc
    table = np.full((B, max_len // ps), n_pages, np.int32)
    table[0, :2] = [3, 0]
    table[1, :3] = [5, 9, 1]
    table[2, :3] = [7, 2, 11]  # row 3 parked
    jc = jm.init_cache(B, max_len, paged=True, page_size=ps, n_pages=n_pages)
    jc["page_table"] = jnp.asarray(table)
    tc = m.init_cache(B, max_len, paged=True, page_size=ps, n_pages=n_pages, device="cpu")
    assert set(tc) == {"page_table", "kv_pages"}
    assert tc["kv_pages"].shape == tuple(jc["kv_pages"].shape) == (2, n_pages, ps, 40)
    tc["page_table"].copy_(torch.from_numpy(table))
    return jc, tc


@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
def test_prefill_and_verify_match_reference(models, cache_mode):
    """A dense-family MLA model (the reference's fused prefill takes it):
    a ragged prefill (row 3 parked), then a verify chunk of 5 at ragged
    lengths, and a decode step; every valid position's logits at 1e-5 and
    the caches after."""
    jm, jp, cfg, p = models["dense"]
    m = Model(cfg)
    assert m.supports_fused_prefill and not Model(tcfg()).supports_fused_prefill
    rng = np.random.default_rng(3)
    B, T = 4, 5
    pre = np.asarray([6, 6, 8, 0])
    prompt = rng.integers(1, cfg.vocab_size, (B, 8))
    jc, tc = fresh_caches(jm, m, cache_mode)
    jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(prompt, jnp.int32), jnp.zeros(B, jnp.int32),
                              jnp.asarray(pre, jnp.int32))
    tl, tc = m.prefill_chunk(p, tc, torch.from_numpy(prompt), torch.zeros(B, dtype=torch.long),
                             torch.from_numpy(pre))
    live = pre > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], rtol=1e-5, atol=1e-5)
    lengths = np.asarray([T, 3, T, 0])
    drafts = rng.integers(1, cfg.vocab_size, (B, T))
    jl, jc = jm.verify_chunk(jp, jc, jnp.asarray(drafts, jnp.int32), jnp.asarray(pre, jnp.int32),
                             jnp.asarray(lengths, jnp.int32))
    tl, tc = m.verify_chunk(p, tc, torch.from_numpy(drafts), torch.from_numpy(pre),
                            torch.from_numpy(lengths))
    for b in range(B):
        np.testing.assert_allclose(tl[b, :lengths[b]].numpy(), np.asarray(jl)[b, :lengths[b]],
                                   rtol=1e-5, atol=1e-5, err_msg=f"row {b}")
    pos = pre + lengths
    nxt = rng.integers(1, cfg.vocab_size, (B, 1))
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt, jnp.int32), jnp.asarray(pos, jnp.int32))
    tl, tc = m.decode_step(p, tc, torch.from_numpy(nxt), torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], rtol=1e-5, atol=1e-5)
    for name in tc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("family", ["moe", "dense"])
def test_layer_tree_and_bridge_round_trip(models, family):
    jm, jp, cfg, p = models[family]
    np_params = jax.tree.map(np.asarray, jp)
    back = params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    assert all(sorted(layer["attn"]) == sorted(MLA_LEAVES) for layer in p["layers"])
    n_dense = cfg.first_k_dense if family == "moe" else cfg.n_layers
    assert ["mlp" in layer for layer in p["layers"]] == [i < n_dense for i in range(cfg.n_layers)]
    assert ("dense_layers" in np_params) == (family == "moe")
    # the port's own init and draw build the same tree; in bf16 the router stays float32
    for dtype in (torch.float32, torch.bfloat16):
        own = Model(cfg, ModelRuntime(dtype=dtype)).init(0, device="cpu")
        bridged = params_from_jax(np_params, device="cpu", dtype=dtype)
        sig = [(path, tuple(t.shape), t.dtype) for path, t in tree_leaves_with_path(own)]
        assert sig == [(path, tuple(t.shape), t.dtype)
                       for path, t in tree_leaves_with_path(bridged)]
        drawn = Model(cfg, ModelRuntime(dtype=dtype)).draw(torch.Generator("cpu").manual_seed(0))
        assert sig == [(path, tuple(t.shape), t.dtype)
                       for path, t in tree_leaves_with_path(drawn)]
        assert all((t.dtype == torch.float32) == (dtype == torch.float32 or path[-1] == "router")
                   for path, t in tree_leaves_with_path(drawn))


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
    assert flat_got["['layers']['attn']['q_up']"][0] == (59, 1536, 128 * 192)
    assert flat_got["['layers']['attn']['kv_down']"][0] == (59, 5120, 576)
    assert flat_got["['dense_layers']['mlp']['wi']"][0] == (1, 5120, 12288)
    assert flat_got["['layers']['moe']['shared']['wi']"][0] == (59, 5120, 2 * 1536)
    assert flat_got["['layers']['moe']['router']"] == ((59, 5120, 160), "float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_draw_gives_mla_leaves_their_scales(dtype):
    """``Model.draw`` at MLA widths large enough to read a std from (d_model
    256, 8 heads, latent 64, queries 128): every MLA leaf in the model
    dtype, the projections' stds within 2% of ``scale / sqrt(d_in)`` (``wo``
    scaled by ``1 / sqrt(2 L)``), the norms ones."""
    cfg = tcfg(d_model=256, n_heads=8, kv_lora_rank=64, q_lora_rank=128, rope_head_dim=16,
               nope_head_dim=32, v_head_dim=32)
    params = Model(cfg, ModelRuntime(dtype=dtype)).draw(torch.Generator("cpu").manual_seed(1))
    depth_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    for layer in params["layers"]:
        attn = layer["attn"]
        assert all(t.dtype == dtype for _, t in tree_leaves_with_path(attn))
        for name in ("q_norm", "kv_norm"):
            assert torch.equal(attn[name]["w"], torch.ones_like(attn[name]["w"]))
        for name in ("q_down", "q_up", "kv_down", "k_up", "v_up", "wo"):
            w = attn[name].float()
            want = (depth_scale if name == "wo" else 1.0) / math.sqrt(w.shape[0])
            assert abs(float(w.std()) / want - 1.0) < 0.02, (name, float(w.std()), want)
            assert abs(float(w.mean())) < 0.05 * want, name
