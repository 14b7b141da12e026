"""Training gradients in the port, plain path on the CPU, against
``jax.value_and_grad`` of the reference's loss on shared weights (f32,
``direct`` attention and the plain SSD scan on both sides): the loss at
rel 1e-5 and every leaf's gradient within 1e-4 of that leaf's largest
reference gradient, for reduced ``mixtral-8x7b`` (``dense`` and
``capacity``, and with a shared expert and a dense first layer), reduced
``mamba2-1.3b``, 5-layer ``zamba2-1.2b`` (a trailing layer past the
last full segment) with ``lora_b`` drawn non-zero (its init is zeros),
so the shared block's LoRA, stacked over its invocations, is held too,
reduced ``whisper-tiny`` over stub frames (the encoder, the stacked
cross attention, LayerNorm's biases, both learned position tables),
reduced ``deepseek-v2-236b`` under ``dense`` and ``capacity`` (every MLA
leaf of its dense first layer and its MoE layer) and reduced
``h2o-danube-3-4b``, whose window of 32 binds on the 48-token rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model, ModelRuntime
from repro_torch.models.weights import params_from_jax, params_to_jax
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

torch.set_num_threads(1)  # the test workers share the host's cores


def with_lora_b(jp):
    lb = jp["shared"]["lora_b"]
    draw = np.random.default_rng(9).standard_normal(lb.shape).astype(np.float32)
    jp = dict(jp, shared=dict(jp["shared"]))
    jp["shared"]["lora_b"] = jnp.asarray(draw / np.sqrt(lb.shape[1]), lb.dtype)
    return jp


GRAD_CASES = {  # name -> (arch, overrides, moe_strategy)
    "mixtral_dense": ("mixtral-8x7b", {}, "dense"),
    "mixtral_capacity": ("mixtral-8x7b", {}, "capacity"),
    "mixtral_shared_dense_capacity": ("mixtral-8x7b", {"n_shared_experts": 1, "first_k_dense": 1},
                                      "capacity"),
    "mamba2": ("mamba2-1.3b", {}, "capacity"),
    "zamba2_5_layers": ("zamba2-1.2b", {"n_layers": 5}, "capacity"),
    "whisper": ("whisper-tiny", {}, "capacity"),
    "deepseek_dense": ("deepseek-v2-236b", {}, "dense"),
    "deepseek_capacity": ("deepseek-v2-236b", {}, "capacity"),
    "danube_window": ("h2o-danube-3-4b", {}, "capacity"),
}
MLA_LEAVES = ["k_up", "kv_down", "kv_norm", "q_down", "q_norm", "q_up", "v_up", "wo"]


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_and_every_gradient_match_jax_grad(case):
    """f32, ``direct`` attention on both sides: the loss at rel 1e-5 and
    every leaf's gradient within 1e-4 of that leaf's largest reference
    gradient."""
    arch, overrides, strategy = GRAD_CASES[case]
    jm = JModel(jreduced(jget_arch(arch), **overrides),
                JRuntime(attn_impl="direct", moe_strategy=strategy))
    jp = jm.init(jax.random.PRNGKey(0))
    if "shared" in jp and "lora_b" in jp["shared"]:
        jp = with_lora_b(jp)
    cfg = reduced(get_arch(arch), **overrides)
    m = Model(cfg, ModelRuntime(attn_impl="direct", moe_strategy=strategy))
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for _, t in tree_leaves_with_path(p):
        t.requires_grad_()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 49))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:  # the encoder's stub frames
        batch["frames"] = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    (jl, _), jg = jax.value_and_grad(lambda q: jm.loss(q, batch), has_aux=True)(jp)
    tl, _ = m.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = params_to_jax(tree_map_with_path(lambda path, t: t.grad, p))
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0]
    got = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * max(scale, 1e-12), (jax.tree_util.keystr(path), err, scale)
    if cfg.use_mla:  # every MLA leaf of every layer is among those held
        for group in ("dense_layers", "layers"):
            attn = jg[group]["attn"]
            assert sorted(attn) == MLA_LEAVES
            assert all(float(np.abs(np.asarray(w)).max()) > 0 for w in jax.tree.leaves(attn))
    if cfg.sliding_window:  # the reduced window binds on the 48-token rows
        assert cfg.sliding_window < batch["tokens"].shape[1]
    if cfg.shared_attn_lora_rank:  # the LoRA's gradients reach both stacked factors
        lora = {jax.tree_util.keystr(k): w for k, w in want if "lora" in jax.tree_util.keystr(k)}
        assert sorted(lora) == ["['shared']['lora_a']", "['shared']['lora_b']"]
        assert all(float(np.abs(w).max()) > 0 for w in lora.values())
