"""The port's full-sequence forward (plain path on the CPU) against the
reference package on shared weights: ``Model.forward`` / ``loss`` / the
prefill step for ``attn_impl`` ``direct``, ``chunked`` and ``kernel`` (on
the CPU the kernel's plain version) against the reference's forward at
its kernel-path test's 1e-4 (loss rtol 1e-5); the ``auto`` rule of
``resolve_attn``; and the flash op's refusal of a gradient."""

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
from repro_torch import prng
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model, ModelRuntime
from repro_torch.models.weights import params_from_jax
from repro_torch.train import optimizer as topt
from repro_torch.train.steps import TrainStepConfig, make_prefill_step, make_train_step

torch.set_num_threads(1)  # the test workers share the host's cores


@pytest.fixture(scope="module")
def shared():
    """(jax model, jax params, port config, port params) on one weight set."""
    jm = JModel(jreduced(jget_arch("ds-paper-100m")), JRuntime(attn_impl="direct"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced(get_arch("ds-paper-100m"))
    return jm, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("impl", ["direct", "chunked", "kernel"])
def test_forward_loss_and_prefill_match_reference(shared, impl):
    jm, jp, cfg, p = shared
    m = Model(cfg, ModelRuntime(attn_impl=impl, attn_chunk=16))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64))
    want = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    got = m.forward(p, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 64, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if impl == "kernel":  # also the reference's own kernel path (interpret mode)
        jk = JModel(jm.cfg, JRuntime(attn_impl="kernel"))
        np.testing.assert_allclose(got.numpy(), np.asarray(jk.forward(jp, jnp.asarray(toks))),
                                   rtol=1e-4, atol=1e-4)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": (np.arange(63)[None] % 5 != 0).astype(np.float32).repeat(2, 0)}
    jl, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet = m.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    np.testing.assert_allclose(
        make_prefill_step(m)(p, torch.from_numpy(toks)).numpy(),
        np.asarray(jmake_prefill_step(jm)(jp, jnp.asarray(toks))), rtol=1e-4, atol=1e-4)


def test_resolve_attn_rules():
    auto = ModelRuntime()
    assert auto.resolve_attn(4096, device="cpu", head_dim=64) == "direct"
    assert auto.resolve_attn(8192, device="cpu", head_dim=64) == "chunked"
    # the card takes the kernel where no gradient is taken and the kernel
    # has the head width and the length fits its 512-token blocks
    assert auto.resolve_attn(512, device="cuda", head_dim=64) == "kernel"
    assert auto.resolve_attn(8192, device="cuda", head_dim=128) == "kernel"
    assert auto.resolve_attn(512, device="cuda", grad=True, head_dim=64) == "direct"
    assert auto.resolve_attn(512, device="cuda", head_dim=16) == "direct"
    assert auto.resolve_attn(600, device="cuda", head_dim=64) == "direct"
    for impl in ("direct", "chunked", "kernel"):
        assert ModelRuntime(attn_impl=impl).resolve_attn(8192, device="cpu") == impl
    with pytest.raises(ValueError, match="attn_impl"):
        ModelRuntime(attn_impl="flash")


def test_kernel_attention_refuses_a_gradient(shared):
    """The flash op runs forward only, as the reference's kernel; a
    training run that asks for it fails at backward instead of dropping
    the attention gradient."""
    _, _, cfg, p = shared
    m = Model(cfg, ModelRuntime(attn_impl="kernel"))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    step = make_train_step(m, TrainStepConfig())
    opt = topt.init_opt_state(p, topt.AdamWConfig())
    with pytest.raises(NotImplementedError, match="no backward"):
        step(p, opt, {"tokens": toks, "labels": toks}, prng.PRNGKey(0, device="cpu"))
