"""The SSM family's model (plain path on the CPU) against the reference
package on shared weights, reduced ``mamba2-1.3b`` (its blocks are in
``test_torch_ssm_block.py``): ``Model.forward``/``loss`` with
``use_ssd_kernel`` False and True against
the reference's both (1e-4, as ``test_model_ssd_kernel_path``); the dense
state cache and its dtypes; the weight bridge and checkpoints keeping
``A_log``/``D``/``dt_bias`` float32 in a bf16 tree; and the eval runner
on a checkpoint the reference wrote."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.storage import ObjectStore as JStore
from repro.launch import train as jtrain
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.core.storage import ObjectStore
from repro_torch.launch import train as ttrain
from repro_torch.models import Model, ModelRuntime
from repro_torch.models.weights import params_from_jax, params_to_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.tree import tree_leaves_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

FP32 = ("A_log", "D", "dt_bias")


@pytest.fixture(scope="module")
def shared():
    """(jax model, jax params, port config, port params) on one weight set."""
    jm = JModel(jreduced(jget_arch("mamba2-1.3b")))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced(get_arch("mamba2-1.3b"))
    return jm, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_reduced_config_and_derived_widths_match_reference():
    jcfg, cfg = jreduced(jget_arch("mamba2-1.3b")), reduced(get_arch("mamba2-1.3b"))
    for name in ("n_layers", "d_model", "vocab_size", "ssm_state", "ssm_headdim", "ssm_chunk",
                 "ssm_conv", "tie_embeddings", "padded_vocab", "d_inner", "ssm_nheads",
                 "is_attention_free"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    full = get_arch("mamba2-1.3b")
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_nheads, full.padded_vocab) == \
        (48, 2048, 4096, 64, 51200)


def test_init_shapes_and_float32_leaves(shared):
    jm, jp, cfg, p = shared
    for dtype in (torch.float32, torch.bfloat16):
        m = Model(cfg, ModelRuntime(dtype=dtype))
        tree, abstract = m.init(0, device="cpu"), m.abstract_params()
        ref = dict(tree_leaves_with_path(p))
        for (path, leaf), (_, meta) in zip(tree_leaves_with_path(tree),
                                           tree_leaves_with_path(abstract)):
            want = torch.float32 if path[-1] in FP32 else dtype
            assert leaf.dtype == meta.dtype == want, path
            assert leaf.shape == meta.shape == ref[path].shape, path
    mixer = Model(cfg).init(0, device="cpu")["layers"][0]["mixer"]
    np.testing.assert_allclose(mixer["A_log"].numpy(), np.asarray(jp["layers"]["mixer"]["A_log"][0]),
                               rtol=1e-6)
    assert set(Model(cfg).init(0, device="cpu")["layers"][0]) == {"ln1", "mixer"}


def test_forward_and_loss_with_and_without_kernel_match_reference(shared):
    jm, jp, cfg, p = shared
    seq = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 33))
    toks = seq[:, :-1]  # whole SSD chunks of 16
    batch = {"tokens": toks, "labels": seq[:, 1:],
             "loss_mask": (np.arange(32)[None] % 4 != 0).astype(np.float32).repeat(2, 0)}
    for use_kernel in (False, True):
        jk = JModel(jm.cfg, JRuntime(use_ssd_kernel=use_kernel))
        want = np.asarray(jk.forward(jp, jnp.asarray(toks)))
        jl, _ = jk.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        for port_kernel in (False, True):
            m = Model(cfg, ModelRuntime(use_ssd_kernel=port_kernel))
            got = m.forward(p, torch.from_numpy(toks))
            assert got.dtype == torch.float32 and got.shape == (2, 32, cfg.padded_vocab)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
            tl, _ = m.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
            np.testing.assert_allclose(m.prefill(p, torch.from_numpy(toks)).numpy(),
                                       want[:, -1:], rtol=1e-4, atol=1e-4)


def test_resolve_ssd_rule_and_training_gradient(shared):
    _, _, cfg, p = shared
    rt = ModelRuntime()
    assert rt.resolve_ssd(device="cuda") is True
    assert rt.resolve_ssd(device="cuda", grad=True) is False
    assert rt.resolve_ssd(device="cpu") is False
    assert ModelRuntime(use_ssd_kernel=True).resolve_ssd(device="cpu", grad=True) is True
    assert ModelRuntime(use_ssd_kernel=False).resolve_ssd(device="cuda") is False
    # a gradient reaches every leaf through the plain path
    leaves = {k: v.clone().requires_grad_() for k, v in p["layers"][0]["mixer"].items()
              if not isinstance(v, dict)}
    params = {**p, "layers": [{**p["layers"][0], "mixer": {**p["layers"][0]["mixer"], **leaves}},
                              p["layers"][1]]}
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 17)))
    loss, _ = Model(cfg).loss(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    loss.backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in leaves.values())


def test_dense_state_cache_layout(shared):
    _, _, cfg, _ = shared
    for dtype in (torch.float32, torch.bfloat16):
        cache = Model(cfg, ModelRuntime(dtype=dtype)).init_cache(3, 64, device="cpu")
        st = cache["state"]
        k = cfg.ssm_conv - 1
        assert st["conv_x"].shape == (cfg.n_layers, 3, k, cfg.d_inner)
        assert st["conv_B"].shape == st["conv_C"].shape == (cfg.n_layers, 3, k, cfg.ssm_state)
        assert st["ssm"].shape == (cfg.n_layers, 3, cfg.ssm_nheads, cfg.ssm_headdim,
                                   cfg.ssm_state)
        assert st["conv_x"].dtype == dtype and st["ssm"].dtype == torch.float32
    with pytest.raises(ValueError, match="paged cache unsupported"):
        Model(cfg).init_cache(2, 32, paged=True, device="cpu")


def test_prefill_then_decode_logits_match_reference(shared):
    """Model.prefill_chunk / decode_step on the dense state cache: ragged
    rows, an idle row, then per-row decode, against the reference."""
    jm, jp, cfg, p = shared
    m = Model(cfg)
    jc = jm.init_cache(3, 32)
    tc = m.init_cache(3, 32, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 8))
    offsets, lengths = np.array([0, 0, 0]), np.array([8, 5, 0])
    jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks), jnp.asarray(offsets), jnp.asarray(lengths))
    tl, tc = m.prefill_chunk(p, tc, torch.from_numpy(toks), torch.from_numpy(offsets),
                             torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=1e-4, atol=1e-4)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (3, 1))
        pos = lengths + step
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for k in tc["state"]:
        np.testing.assert_allclose(f32(tc["state"][k]), f32(jc["state"][k]), rtol=1e-4, atol=1e-4)


def test_bridge_and_checkpoint_keep_float32_leaves_in_a_bf16_tree(shared, tmp_path):
    jm, jp, cfg, _ = shared
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    jb["layers"]["mixer"] = {k: (jp["layers"]["mixer"][k] if k in FP32 else v)
                             for k, v in jb["layers"]["mixer"].items()}
    tb = params_from_jax(jax.tree.map(np.asarray, jb), device="cpu", dtype=torch.bfloat16)
    for path, leaf in tree_leaves_with_path(tb):
        assert leaf.dtype == (torch.float32 if path[-1] in FP32 else torch.bfloat16), path
    back = params_to_jax(tb)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jb)[0],
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    # the port's bf16 checkpoint restores in both packages with each leaf's dtype
    store = ObjectStore(str(tmp_path))
    tckpt.save_state(store, "m", 1, tb)
    m = Model(cfg, ModelRuntime(dtype=torch.bfloat16))
    got, _ = tckpt.restore_state(store, "m", 1, m.abstract_params(), device="cpu")
    for (path, x), (_, y) in zip(tree_leaves_with_path(got), tree_leaves_with_path(tb)):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jb)
    jgot, _ = jckpt.restore_checkpoint(JStore(str(tmp_path)), "m", 1, like)
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jb)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_eval_reads_a_reference_checkpoint(shared, tmp_path):
    jm, jp, _, _ = shared
    jckpt.save_checkpoint(JStore(str(tmp_path)), "s", 1, jp)
    job = {"arch": "mamba2-1.3b", "arch_overrides": "reduced", "run": "s", "seq_len": 32,
           "global_batch": 2, "n_batches": 2}
    ctx = types.SimpleNamespace(store=JStore(str(tmp_path)), heartbeat=lambda progress=None: None)
    want = jtrain.eval_payload(job, ctx)
    got = ttrain.run_eval(job, ObjectStore(str(tmp_path)), lambda progress=None: None,
                          device="cpu")
    assert got["ckpt_step"] == want["ckpt_step"] == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)
