"""Remat in the port (``ModelRuntime.remat``, ``remat_segment``), plain
path on the CPU.

- The loss and every leaf's gradient under remat against
  ``jax.value_and_grad`` of the reference under the same
  ``ModelRuntime(remat=True, remat_segment=k)`` (f32, ``direct``
  attention and the plain SSD scan on both sides; the tolerances of
  ``test_torch_grads.py``: loss rel 1e-5, each leaf within 1e-4 of its
  largest reference gradient): reduced ``ds-paper-100m`` at 4 layers
  with k 0 and 2; reduced ``mixtral-8x7b`` with a dense first layer and a
  shared expert at 4 layers with k 3 (the dense group of 1 a layer at a
  time, the MoE group of 3 as one segment); reduced ``mamba2-1.3b`` with
  k 2; 5-layer ``zamba2-1.2b`` with ``lora_b`` drawn non-zero and k 2
  (the hybrid ignores the segment).
- The port's gradients with and without remat equal within rel 1e-6.
- The bytes saved for the backward (``saved_tensors_hooks``, parameters
  left out) fall with remat and further with a segment that divides its
  group (a MoE's dense layers and the rest apart); they do not move for
  a segment that divides no group, for the hybrid's segment or for the
  encoder-decoder, which takes none.
- The recompute resolves the same attention and SSD route as the forward
  it replays (the route the card would take, read through
  ``resolve_attn``/``resolve_ssd``); a reentrant checkpoint, whose
  forward runs without the gradient, would not.
"""

import jax
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model, ModelRuntime
from repro_torch.models import transformer
from repro_torch.models.weights import params_from_jax, params_to_jax
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map_with_path
from test_torch_grads import with_lora_b

torch.set_num_threads(1)  # the test workers share the host's cores

REMAT_CASES = {  # name -> (arch, overrides, moe_strategy, remat_segment)
    "ds_paper_4_layers_k0": ("ds-paper-100m", {"n_layers": 4}, "capacity", 0),
    "ds_paper_4_layers_k2": ("ds-paper-100m", {"n_layers": 4}, "capacity", 2),
    "mixtral_dense_first_shared_k3": (
        "mixtral-8x7b", {"n_layers": 4, "first_k_dense": 1, "n_shared_experts": 1},
        "capacity", 3),
    "mamba2_k2": ("mamba2-1.3b", {}, "capacity", 2),
    "zamba2_5_layers_k2": ("zamba2-1.2b", {"n_layers": 5}, "capacity", 2),
}


def shared_weights(arch, overrides):
    """The reference's seed-0 tree (a hybrid's ``lora_b`` drawn non-zero)
    and the port's config."""
    jp = JModel(jreduced(jget_arch(arch), **overrides)).init(jax.random.PRNGKey(0))
    if "shared" in jp and "lora_b" in jp["shared"]:
        jp = with_lora_b(jp)
    return jax.tree.map(np.asarray, jp), reduced(get_arch(arch), **overrides)


def batch_for(cfg, seed: int = 4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 49))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:  # the encoder's stub frames
        batch["frames"] = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def port_loss_and_grads(cfg, rt: ModelRuntime, jp, batch):
    """The port's loss and its gradient tree in the reference's layout."""
    p = params_from_jax(jp, device="cpu")
    for _, t in tree_leaves_with_path(p):
        t.requires_grad_()
    loss, _ = Model(cfg, rt).loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), params_to_jax(tree_map_with_path(lambda path, t: t.grad, p))


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_loss_and_every_gradient_match_jax_grad(case):
    arch, overrides, strategy, seg = REMAT_CASES[case]
    jp, cfg = shared_weights(arch, overrides)
    knobs = dict(attn_impl="direct", moe_strategy=strategy, remat=True, remat_segment=seg)
    jm = JModel(jreduced(jget_arch(arch), **overrides), JRuntime(**knobs))
    batch = batch_for(cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda q: jm.loss(q, batch), has_aux=True))(jp)
    tl, grads = port_loss_and_grads(cfg, ModelRuntime(**knobs), jp, batch)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0]
    got = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * max(scale, 1e-12), (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("case", ["ds_paper_4_layers_k2", "mixtral_dense_first_shared_k3",
                                  "mamba2_k2", "zamba2_5_layers_k2"])
def test_remat_leaves_the_port_gradients_unchanged(case):
    arch, overrides, strategy, seg = REMAT_CASES[case]
    jp, cfg = shared_weights(arch, overrides)
    batch = batch_for(cfg)
    runs = [port_loss_and_grads(cfg, ModelRuntime(attn_impl="direct", moe_strategy=strategy,
                                                  remat=remat, remat_segment=seg), jp, batch)
            for remat in (False, True)]
    (l0, g0), (l1, g1) = runs
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g0)):
        assert float(np.abs(a - b).max()) <= 1e-6 * max(float(np.abs(b).max()), 1e-12)


def saved_bytes(arch, overrides, **knobs) -> int:
    """Bytes of the distinct tensors saved for the backward of one loss
    (the parameters left out), through ``saved_tensors_hooks``: what a
    train step holds between its forward and its backward."""
    cfg = reduced(get_arch(arch), **overrides)
    model = Model(cfg, ModelRuntime(attn_impl="direct", **knobs))
    params = model.init(0, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    own = {t.untyped_storage().data_ptr() for t in leaves}
    seen = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in own:
            seen[ptr] = max(seen.get(ptr, 0), t.untyped_storage().nbytes())
        return t

    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss(params, batch)
    loss.backward()
    return sum(seen.values())


def test_saved_bytes_fall_with_remat_and_further_with_a_segment():
    dense = ("ds-paper-100m", {"n_layers": 4})
    none, layer, seg = (saved_bytes(*dense, remat=r, remat_segment=k)
                        for r, k in ((False, 0), (True, 0), (True, 2)))
    assert none > layer > seg, (none, layer, seg)
    # a segment that does not divide the group checkpoints a layer at a time
    assert saved_bytes(*dense, remat=True, remat_segment=3) == layer
    # the segment divides each group apart: 1 dense layer, then 3 MoE layers
    moe = ("mixtral-8x7b", {"n_layers": 4, "first_k_dense": 1})
    assert saved_bytes(*moe, remat=True) > saved_bytes(*moe, remat=True, remat_segment=3)
    assert saved_bytes(*moe, remat=True) == saved_bytes(*moe, remat=True, remat_segment=2)
    ssm = ("mamba2-1.3b", {"n_layers": 4})
    assert saved_bytes(*ssm) > saved_bytes(*ssm, remat=True) > saved_bytes(
        *ssm, remat=True, remat_segment=2)
    hybrid = ("zamba2-1.2b", {"n_layers": 5})  # the segment is ignored
    h0, h1, h2 = (saved_bytes(*hybrid, remat=r, remat_segment=k)
                  for r, k in ((False, 0), (True, 0), (True, 2)))
    assert h0 > h1 == h2, (h0, h1, h2)
    enc_dec = ("whisper-tiny", {})  # no remat in the encoder or the decoder
    assert saved_bytes(*enc_dec) == saved_bytes(*enc_dec, remat=True, remat_segment=2)


RESOLVE = (ModelRuntime.resolve_attn, ModelRuntime.resolve_ssd)


def record_routes(monkeypatch, cfg, rt: ModelRuntime) -> dict:
    """Every attention and SSD route resolved in one loss's forward and in
    its backward (the recompute), as the card would resolve it: the
    ``grad`` the model passes and the route ``resolve_attn``/``resolve_ssd``
    give on a CUDA device."""
    calls = {"forward": [], "backward": []}
    phase = ["forward"]
    attn, ssd = RESOLVE

    def resolve_attn(self, seq_len, *, device=None, grad=False, **kw):
        calls[phase[0]].append(("attn", grad, attn(self, seq_len, device="cuda", grad=grad, **kw)))
        return attn(self, seq_len, device=device, grad=grad, **kw)

    def resolve_ssd(self, *, device=None, grad=False):
        calls[phase[0]].append(("ssd", grad, ssd(self, device="cuda", grad=grad)))
        return ssd(self, device=device, grad=grad)

    monkeypatch.setattr(ModelRuntime, "resolve_attn", resolve_attn)
    monkeypatch.setattr(ModelRuntime, "resolve_ssd", resolve_ssd)
    model = Model(cfg, rt)
    params = model.init(0, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_()
    loss, _ = model.loss(params, {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()})
    phase[0] = "backward"
    loss.backward()
    return calls


@pytest.mark.parametrize("arch,overrides", [
    ("ds-paper-100m", {"head_dim": 64}),  # a width the flash kernel takes
    ("mamba2-1.3b", {}),
])
def test_recompute_takes_the_forward_route(monkeypatch, arch, overrides):
    cfg = reduced(get_arch(arch), **overrides)
    calls = record_routes(monkeypatch, cfg, ModelRuntime(remat=True))
    assert calls["forward"] and calls["backward"] == calls["forward"], calls
    assert all(grad and route in ("direct", False) for _, grad, route in calls["forward"]), calls
    # a reentrant checkpoint runs its forward without the gradient: on the
    # card that forward would take the kernel and the recompute the plain path
    monkeypatch.setattr(transformer, "checkpoint", lambda fn, *a, use_reentrant:
                        torch.utils.checkpoint.checkpoint(fn, *a, use_reentrant=True))
    calls = record_routes(monkeypatch, cfg, ModelRuntime(remat=True))
    assert [r for _, _, r in calls["forward"]] != [r for _, _, r in calls["backward"]], calls
    assert all(route in ("kernel", True) for _, _, route in calls["forward"]), calls
