"""The dense zoo (``granite-34b``: MQA with an ungated GELU MLP;
``qwen2-72b``: GQA with QKV bias; ``nemotron-4-340b``: squared-ReLU MLP
at head width 192) in the port, plain path on the CPU, against the
reference package on shared weights at ``reduced()`` size.

The reference draws ``bq``/``bk``/``bv`` as zeros, which would hide the
bias; every test here redraws them non-zero (numpy, std ``BIAS_STD``) in
the one tree both packages use.  Held: the configs field for field (full
and reduced), the weight bridge both ways (``bq``/``bk``/``bv`` present,
no ``wg`` for the ungated MLPs), the full-sequence forward, loss and
prefill step (direct attention and the flash op's plain version) at 1e-4,
paged prefill then decode logits and pages at 1e-4 against the
reference's gather path and its Pallas kernel in interpret mode (the fold
at G = ``n_heads`` for MQA), dense-cache prefill then decode logits,
``kernel_path`` at each model's full-width serving shapes, and
``Model.draw`` (the device draw, run here on a CPU generator) against
``Model.init``'s tree."""

import dataclasses
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
from repro.train.steps import make_prefill_step as jmake_prefill_step
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_decode import kernel_path
from repro_torch.models import Model, ModelRuntime
from repro_torch.models.weights import params_from_jax, params_to_jax
from repro_torch.train.steps import make_prefill_step
from repro_torch.tree import tree_leaves, tree_map_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

ZOO = ("granite-34b", "qwen2-72b", "nemotron-4-340b")
TOL = dict(rtol=1e-4, atol=1e-4)
BIAS_STD = 0.5  # q, k and v are ~N(0, 1) at init: a bias of this size moves every logit


def with_bias(jp, seed: int = 9):
    """The reference's tree with ``bq``/``bk``/``bv`` redrawn non-zero."""
    attn = jp["layers"].get("attn", {})
    if "bq" not in attn:
        return jp
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        b = attn[name]
        attn[name] = jnp.asarray(rng.standard_normal(b.shape).astype(np.float32) * BIAS_STD,
                                 b.dtype)
    return jp


@pytest.fixture(scope="module")
def models():
    """arch -> (jax model, jax params, port config, port params)."""
    out = {}
    for arch in ZOO:
        jm = JModel(jreduced(jget_arch(arch)), JRuntime(attn_impl="direct",
                                                        paged_attn_impl="jnp"))
        jp = with_bias(jm.init(jax.random.PRNGKey(0)))
        out[arch] = (jm, jp, reduced(get_arch(arch)),
                     params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("arch", ZOO)
def test_config_matches_reference(arch):
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(jget_arch(arch))
    assert (dataclasses.asdict(reduced(get_arch(arch)))
            == dataclasses.asdict(jreduced(jget_arch(arch))))


def test_zoo_features_are_what_the_configs_say():
    g, q, n = (get_arch(a) for a in ZOO)
    assert (g.n_kv_heads, g.activation, g.qkv_bias) == (1, "gelu", False)
    assert (q.n_heads // q.n_kv_heads, q.activation, q.qkv_bias) == (8, "silu", True)
    assert (n.resolved_head_dim, n.activation, n.qkv_bias) == (192, "relu2", False)
    assert reduced(g).n_kv_heads == 1  # MQA survives the reduction


@pytest.mark.parametrize("arch", ZOO)
def test_params_round_trip_through_the_bridge(models, arch):
    jm, jp, cfg, p = models[arch]
    np_params = jax.tree.map(np.asarray, jp)
    back = params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    layer = p["layers"][0]
    assert ("bq" in layer["attn"]) == cfg.qkv_bias
    if cfg.qkv_bias:
        assert all(float(layer["attn"][n].abs().max()) > 0 for n in ("bq", "bk", "bv"))
    assert ("wg" in layer["mlp"]) == (cfg.activation == "silu")
    # the port's own init builds the same tree
    own = Model(cfg).init(0, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), own) == jax.tree.map(
        lambda t: (tuple(t.shape), t.dtype), p)


@pytest.mark.parametrize("impl", ["direct", "kernel"])
@pytest.mark.parametrize("arch", ZOO)
def test_forward_loss_and_prefill_match_reference(models, arch, impl):
    jm, jp, cfg, p = models[arch]
    m = Model(cfg, ModelRuntime(attn_impl=impl))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48))
    want = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    got = m.forward(p, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = m.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(
        make_prefill_step(m)(p, torch.from_numpy(toks)).numpy(),
        np.asarray(jmake_prefill_step(jm)(jp, jnp.asarray(toks))), **TOL)


@pytest.mark.parametrize("paged_impl", ["jnp", "kernel"])
@pytest.mark.parametrize("arch", ZOO)
def test_paged_prefill_then_decode_match_reference(models, arch, paged_impl):
    """Ragged chunked prefill (a row resuming mid-page, an inactive row)
    then ragged decode steps with a parked row on the paged cache: logits
    at valid positions and the written pages at 1e-4, against the
    reference's gather path and its Pallas kernel in interpret mode."""
    jm, jp, cfg, p = models[arch]
    jm = JModel(jm.cfg, JRuntime(paged_attn_impl=paged_impl))
    m = Model(cfg)
    B, max_len, ps, n_pages = 4, 32, 8, 12
    table = np.full((B, max_len // ps), n_pages, np.int32)
    table[0, :2] = [3, 0]
    table[1, :2] = [5, 9]
    table[2, :1] = [7]  # row 3 stays parked
    jc = jm.init_cache(B, max_len, paged=True, page_size=ps, n_pages=n_pages)
    jc["page_table"] = jnp.asarray(table)
    tc = m.init_cache(B, max_len, paged=True, page_size=ps, n_pages=n_pages, device="cpu")
    tc["page_table"].copy_(torch.from_numpy(table))
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
        np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], **TOL)
        pos = pos + 1
    used = sorted({int(x) for x in table.ravel() if x < n_pages})
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tc[name].numpy()[:, used], np.asarray(jc[name])[:, used],
                                   **TOL)


@pytest.mark.parametrize("arch", ZOO)
def test_dense_prefill_then_decode_match_reference(models, arch):
    """The dense per-slot cache: ragged prefill then decode steps, logits
    of the live rows and the cache at 1e-4."""
    jm, jp, cfg, p = models[arch]
    m = Model(cfg)
    B, max_len = 3, 16
    jc = jm.init_cache(B, max_len)
    tc = m.init_cache(B, max_len, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 256, (B, 5)).astype(np.int32)
    offs = np.zeros(B, np.int32)
    lens = np.asarray([5, 2, 4], np.int32)
    jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks), jnp.asarray(offs), jnp.asarray(lens))
    tl, tc = m.prefill_chunk(p, tc, torch.from_numpy(toks).long(), torch.from_numpy(offs),
                             torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = lens.copy()
    for _ in range(3):
        nxt = rng.integers(1, 256, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(nxt).long(), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


# The paged kernel's path at each model's full-width serving shapes: decode
# (T 1) and chunked prefill (T 16), G = n_heads / n_kv_heads folded queries
# of one KV head each.
SERVING_PATHS = {
    ("granite-34b", torch.bfloat16, 1): "tensor_core",  # G*T 48, key splits
    ("granite-34b", torch.bfloat16, 16): "tensor_core",  # G*T 768: 6 row groups of 8 M-tiles
    ("granite-34b", torch.float32, 1): "tensor_core",  # f32 in 3xTF32
    ("granite-34b", torch.float32, 16): "tensor_core",
    ("qwen2-72b", torch.bfloat16, 1): "decode",  # G*T 8 at dk 128
    ("qwen2-72b", torch.bfloat16, 16): "tensor_core",  # G*T 128: 8 M-tiles on one stage
    ("qwen2-72b", torch.float32, 1): "decode",
    ("qwen2-72b", torch.float32, 16): "tensor_core",
    ("nemotron-4-340b", torch.bfloat16, 1): "tensor_core",  # dk 192: G*T 12
    ("nemotron-4-340b", torch.bfloat16, 16): "tensor_core",  # 192 rows: 2 groups of 6
    ("nemotron-4-340b", torch.float32, 1): "tensor_core",  # f32 at dk 192 in 3xTF32
    ("nemotron-4-340b", torch.float32, 16): "tensor_core",
}


@pytest.mark.parametrize("arch,dtype,T", sorted(SERVING_PATHS, key=str))
def test_kernel_path_at_the_zoo_serving_shapes(arch, dtype, T):
    cfg = get_arch(arch)
    g, hd = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    assert kernel_path(dtype, g * T, hd, hd) == SERVING_PATHS[(arch, dtype, T)]


# ------------------------------------------------------------- the device draw
def _signature(tree):
    return tree_map_with_path(lambda path, t: (path, tuple(t.shape), t.dtype), tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ZOO + ("ds-paper-100m", "mamba2-1.3b", "zamba2-1.2b"))
def test_draw_builds_init_tree(arch, dtype):
    """Every leaf where ``init`` puts it, with its shape and dtype (an SSM's
    float32 leaves float32 in a bf16 model, equal to ``init``'s)."""
    m = Model(reduced(get_arch(arch)), ModelRuntime(dtype=dtype))
    drawn = m.draw(torch.Generator("cpu").manual_seed(0))
    own = m.init(0, device="cpu")
    assert _signature(drawn) == _signature(own)
    assert all(t.device.type == "cpu" for t in tree_leaves(drawn))
    if "mixer" in own["layers"][0]:
        for name in ("A_log", "D", "dt_bias"):
            assert torch.equal(drawn["layers"][0]["mixer"][name], own["layers"][0]["mixer"][name])
    again = m.draw(torch.Generator("cpu").manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(drawn), tree_leaves(again)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ZOO)
def test_draw_scales_match_init(arch, dtype):
    """At mid-size leaves (d_model 256, d_ff 1024, 8 layers): each drawn
    leaf's std within 2% of ``init``'s scale, its mean within 5 standard
    errors of 0; norms and biases exactly their constants."""
    cfg = reduced(get_arch(arch), d_model=256, d_ff=1024, n_layers=8)
    p = Model(cfg, ModelRuntime(dtype=dtype)).draw(torch.Generator("cpu").manual_seed(1))
    depth = 1.0 / math.sqrt(2 * cfg.n_layers)
    layer = p["layers"][3]
    want = {"embed": (p["embed"], 0.02), "lm_head": (p["lm_head"], 1 / math.sqrt(256)),
            "wq": (layer["attn"]["wq"], 1 / math.sqrt(256)),
            "wo": (layer["attn"]["wo"], depth / math.sqrt(64)),
            "wi": (layer["mlp"]["wi"], 1 / math.sqrt(256)),
            "mlp_wo": (layer["mlp"]["wo"], depth / math.sqrt(1024))}
    for name, (t, std) in want.items():
        assert t.dtype == dtype, name
        x = t.float()
        assert abs(float(x.std()) / std - 1) < 0.02, (name, float(x.std()), std)
        assert abs(float(x.mean())) < 5 * std / math.sqrt(x.numel()), name
    assert (layer["ln1"]["w"] == 1).all() and (p["ln_f"]["w"] == 1).all()
    if cfg.qkv_bias:
        assert all((layer["attn"][n] == 0).all() for n in ("bq", "bk", "bv"))
