"""The hybrid family's model (plain path on the CPU) against the reference
package on shared weights, reduced ``zamba2-1.2b`` (4 mamba2 layers, the
shared attention block every 2, LoRA rank 8): the reduced config and its
derived widths; the full-width parameter tree's paths and shapes against
``jax.eval_shape`` of the reference's init, nothing allocated;
``Model.forward``/``loss`` with ``use_ssd_kernel`` False and True on the
reference side (1e-4), at the default depth and at ``n_layers=5`` so that
a trailing layer past the last full segment runs, as at full width (38 =
6 x 6 + 2); prefill then decode on the dense cache, ``shared_k`` and
``shared_v`` included; the weight bridge and checkpoints keeping
``A_log``/``D``/``dt_bias`` float32 in a bf16 tree and the LoRA stacked
over the invocations.  ``lora_b`` is drawn non-zero in both trees (the
reference initialises it to zeros, which would hide the LoRA)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.storage import ObjectStore as JStore
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.core.storage import ObjectStore
from repro_torch.models import Model, ModelRuntime
from repro_torch.models.weights import params_from_jax, params_to_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.tree import tree_leaves_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

ARCH = "zamba2-1.2b"
FP32 = ("A_log", "D", "dt_bias")
DEPTHS = (4, 5)  # the reduced default (2 full segments), and one trailing layer


def with_lora_b(jp):
    """The reference's tree with ``lora_b`` drawn from a numpy normal of std
    1/sqrt(r) (its init is zeros)."""
    lb = jp["shared"]["lora_b"]
    draw = np.random.default_rng(9).standard_normal(lb.shape).astype(np.float32)
    jp = dict(jp, shared=dict(jp["shared"]))
    jp["shared"]["lora_b"] = jnp.asarray(draw / np.sqrt(lb.shape[1]), lb.dtype)
    return jp


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda n: f"layers{n}")
def shared(request):
    """(jax model, jax params, port config, port params) on one weight set."""
    n = request.param
    jm = JModel(jreduced(jget_arch(ARCH), n_layers=n))
    jp = with_lora_b(jm.init(jax.random.PRNGKey(0)))
    cfg = reduced(get_arch(ARCH), n_layers=n)
    return jm, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_reduced_config_and_derived_widths_match_reference():
    jcfg, cfg = jreduced(jget_arch(ARCH)), reduced(get_arch(ARCH))
    for name in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                 "ssm_state", "ssm_headdim", "ssm_chunk", "ssm_conv", "shared_attn_every",
                 "shared_attn_lora_rank", "activation", "tie_embeddings", "padded_vocab",
                 "d_inner", "ssm_nheads", "is_attention_free"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.n_layers, cfg.shared_attn_every, cfg.shared_attn_lora_rank) == (4, 2, 8)
    full = get_arch(ARCH)
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                 "padded_vocab", "ssm_state", "ssm_headdim", "ssm_chunk",
                 "shared_attn_every", "shared_attn_lora_rank", "activation", "tie_embeddings"):
        assert getattr(full, name) == getattr(jget_arch(ARCH), name), name
    assert (full.n_layers, full.d_model, full.padded_vocab, full.n_layers // full.shared_attn_every,
            2 * full.d_model // full.n_heads) == (38, 2048, 32768, 6, 128)


def test_full_width_abstract_tree_matches_reference_eval_shape():
    """Every leaf path and shape of the port's abstract tree at full width
    against ``jax.eval_shape`` of the reference's init (nothing allocated
    on either side)."""
    m = Model(get_arch(ARCH), ModelRuntime(dtype=torch.bfloat16))
    abstract = m.abstract_params()
    like = jax.eval_shape(JModel(jget_arch(ARCH), JRuntime(dtype=jnp.bfloat16)).init,
                          jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(like)[0]:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        if key[0] == "layers":  # the port lists the layers: one leaf a layer
            want.update({("layers", str(i)) + key[1:]: (tuple(leaf.shape[1:]), str(leaf.dtype))
                         for i in range(leaf.shape[0])})
        else:
            want[key] = (tuple(leaf.shape), str(leaf.dtype))
    got = {tuple(str(k) for k in path): (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in tree_leaves_with_path(abstract)}
    assert all(t.device.type == "meta" for _, t in tree_leaves_with_path(abstract))
    assert got == want
    sh = abstract["shared"]
    assert sh["attn"]["wq"].shape == (4096, 4096) and sh["down"].shape == (4096, 2048)
    assert sh["lora_a"].shape == (6, 4096, 128) and sh["lora_b"].shape == (6, 128, 4096)
    assert sh["mlp"]["wi"].shape == sh["mlp"]["wg"].shape == (4096, 8192)


def test_init_draws_the_reference_scales():
    """The port's own seed init: the shared block's leaves at the
    reference's shapes and scales (``lora_b`` zeros, ``lora_a`` normal of
    std 1/sqrt(2d), ``down`` and the output projections depth-scaled)."""
    cfg = reduced(get_arch(ARCH))
    p = Model(cfg).init(0, device="cpu")["shared"]
    d2 = 2 * cfg.d_model
    assert float(p["lora_b"].abs().max()) == 0.0 and float(p["ln1"]["w"].min()) == 1.0
    assert p["lora_a"].std().item() == pytest.approx(1 / np.sqrt(d2), rel=0.1)
    assert p["down"].std().item() == pytest.approx(
        1 / np.sqrt(2 * cfg.n_layers) / np.sqrt(d2), rel=0.1)
    assert set(p) == {"ln1", "attn", "ln2", "mlp", "down", "lora_a", "lora_b"}


def test_forward_and_loss_match_reference(shared):
    jm, jp, cfg, p = shared
    seq = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 33))
    toks = seq[:, :-1]  # whole SSD chunks of 16
    batch = {"tokens": toks, "labels": seq[:, 1:],
             "loss_mask": (np.arange(32)[None] % 4 != 0).astype(np.float32).repeat(2, 0)}
    m = Model(cfg)
    got = m.forward(p, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 32, cfg.padded_vocab)
    tl, _ = m.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    for use_kernel in (False, True):
        jk = JModel(jm.cfg, JRuntime(use_ssd_kernel=use_kernel))
        want = np.asarray(jk.forward(jp, jnp.asarray(toks)))
        jl, _ = jk.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # the LoRA is live: zeroing it moves the logits
    off = {**p, "shared": {**p["shared"], "lora_b": torch.zeros_like(p["shared"]["lora_b"])}}
    assert (m.forward(off, torch.from_numpy(toks)) - got).abs().max() > 1e-3


def test_shared_block_runs_before_each_full_segment(shared):
    _, _, cfg, _ = shared
    m = Model(cfg)
    at = [m._shared_at(i) for i in range(cfg.n_layers)]
    assert at[:4] == [0, None, 1, None] and at[4:] == [None] * (cfg.n_layers - 4)
    full = Model(get_arch(ARCH))
    at = [full._shared_at(i) for i in range(38)]
    assert [i for i, v in enumerate(at) if v is not None] == [0, 6, 12, 18, 24, 30]
    assert at[36:] == [None, None]


def test_dense_cache_layout(shared):
    _, _, cfg, _ = shared
    for dtype in (torch.float32, torch.bfloat16):
        m = Model(cfg, ModelRuntime(dtype=dtype))
        cache = m.init_cache(3, 40, device="cpu")
        n_inv = cfg.n_layers // cfg.shared_attn_every
        assert set(cache) == {"state", "shared_k", "shared_v"}
        for k in ("shared_k", "shared_v"):
            assert cache[k].shape == (n_inv, 3, 40, cfg.n_kv_heads, 2 * cfg.d_model // cfg.n_heads)
            assert cache[k].dtype == dtype
        assert cache["state"]["ssm"].shape[0] == cfg.n_layers
        assert cache["state"]["ssm"].dtype == torch.float32
        assert not m.supports_paged_cache
        with pytest.raises(ValueError, match="paged cache unsupported"):
            m.init_cache(2, 32, paged=True, device="cpu")


def test_prefill_then_decode_logits_match_reference(shared):
    """Model.prefill_chunk / decode_step on the dense cache: ragged rows, an
    idle row, a second chunk at an offset, then per-row decode, against
    the reference; the state and the shared block's K/V after."""
    jm, jp, cfg, p = shared
    m = Model(cfg)
    jc = jm.init_cache(3, 32)
    tc = m.init_cache(3, 32, device="cpu")
    rng = np.random.default_rng(5)
    lengths = np.array([8, 5, 0])
    for offsets in (np.array([0, 0, 0]), lengths.copy()):
        toks = rng.integers(0, cfg.vocab_size, (3, 8))
        jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks), jnp.asarray(offsets),
                                  jnp.asarray(lengths))
        tl, tc = m.prefill_chunk(p, tc, torch.from_numpy(toks), torch.from_numpy(offsets),
                                 torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=1e-4, atol=1e-4)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (3, 1))
        pos = 2 * lengths + step
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for k in tc["state"]:
        np.testing.assert_allclose(f32(tc["state"][k]), f32(jc["state"][k]), rtol=1e-4, atol=1e-4)
    for k in ("shared_k", "shared_v"):
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), rtol=1e-4, atol=1e-4)


def test_bridge_and_checkpoint_keep_float32_leaves_and_stacked_lora(shared, tmp_path):
    jm, jp, cfg, _ = shared
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    jb["layers"]["mixer"] = {k: (jp["layers"]["mixer"][k] if k in FP32 else v)
                             for k, v in jb["layers"]["mixer"].items()}
    tb = params_from_jax(jax.tree.map(np.asarray, jb), device="cpu", dtype=torch.bfloat16)
    for path, leaf in tree_leaves_with_path(tb):
        assert leaf.dtype == (torch.float32 if path[-1] in FP32 else torch.bfloat16), path
    n_inv = cfg.n_layers // cfg.shared_attn_every
    assert tb["shared"]["lora_a"].shape == (n_inv, 2 * cfg.d_model, 8)
    assert tb["shared"]["lora_b"].shape == (n_inv, 8, 2 * cfg.d_model)
    assert isinstance(tb["layers"], list) and len(tb["layers"]) == cfg.n_layers
    back = params_to_jax(tb)
    flat_back = {tuple(str(getattr(k, "key", k)) for k in path): leaf
                 for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]}
    for path, a in jax.tree_util.tree_flatten_with_path(jb)[0]:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_array_equal(np.asarray(a, np.float32), flat_back[key])
    # the port's bf16 checkpoint restores in both packages with each leaf's dtype
    store = ObjectStore(str(tmp_path))
    tckpt.save_state(store, "z", 1, tb)
    m = Model(cfg, ModelRuntime(dtype=torch.bfloat16))
    got, _ = tckpt.restore_state(store, "z", 1, m.abstract_params(), device="cpu")
    for (path, x), (_, y) in zip(tree_leaves_with_path(got), tree_leaves_with_path(tb)):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jb)
    jgot, _ = jckpt.restore_checkpoint(JStore(str(tmp_path)), "z", 1, like)
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jb)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
