"""The mamba2 block of the port (plain path on the CPU) against the
reference package's on shared weights, reduced ``mamba2-1.3b``: the
full-sequence, chunked-prefill (carried state, padded and idle rows) and
decode paths against ``apply_mamba2*``, each with and without the SSD
kernel route (1e-5 f32, 2e-2 bf16), and the gated RMSNorm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro_torch.configs import get_arch, reduced
from repro_torch.models import ssm
from repro_torch.models.layers import rmsnorm_gated
from repro_torch.models.weights import params_from_jax

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


def test_gated_norm_matches_reference():
    from repro.models.layers import rmsnorm_gated as jrmsnorm_gated

    rng = np.random.default_rng(1)
    x, g = rng.standard_normal((3, 5, 32)), rng.standard_normal((3, 5, 32))
    w = rng.standard_normal(32) + 1.0
    for jd, td, t in ((jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 2e-2)):
        want = jrmsnorm_gated({"w": jnp.asarray(w, jd)}, jnp.asarray(x, jd), jnp.asarray(g, jd), 1e-5)
        got = rmsnorm_gated({"w": torch.tensor(w).to(td)}, torch.tensor(x).to(td),
                            torch.tensor(g).to(td), 1e-5)
        assert got.dtype == td
        np.testing.assert_allclose(f32(got), f32(want), rtol=t, atol=t)


def _mixer(jp, p, dtype):
    jmix = jax.tree.map(lambda a: a[0], jp["layers"]["mixer"])
    tmix = p["layers"][0]["mixer"]
    if dtype == "bfloat16":
        jmix = {k: (v.astype(jnp.bfloat16) if k not in FP32 else v) if not isinstance(v, dict)
                else jax.tree.map(lambda a: a.astype(jnp.bfloat16), v) for k, v in jmix.items()}
        tmix = {k: (v.to(torch.bfloat16) if k not in FP32 else v) if not isinstance(v, dict)
                else {kk: vv.to(torch.bfloat16) for kk, vv in v.items()} for k, v in tmix.items()}
    return jmix, tmix


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_paths_match_reference(shared, dtype):
    """Full sequence, chunked prefill from a carried state (padded rows,
    one idle row) and decode against the reference's block functions."""
    jm, jp, cfg, p = shared
    jcfg = jm.cfg
    jmix, tmix = _mixer(jp, p, dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    t = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 32, cfg.d_model)).astype(np.float32)

    want = jssm.apply_mamba2(jmix, jnp.asarray(x, jd), jcfg)
    for use_kernel in (False, True):
        got = ssm.apply_mamba2(tmix, torch.from_numpy(x).to(td), cfg, use_kernel=use_kernel)
        assert got.dtype == td
        np.testing.assert_allclose(f32(got), f32(want), **t)

    state = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jssm.mamba2_decode_state(jcfg, 3, jd).items()}
    jstate = {k: jnp.asarray(v, jnp.float32 if k == "ssm" else jd) for k, v in state.items()}
    tstate = {k: torch.from_numpy(v).to(torch.float32 if k == "ssm" else td)
              for k, v in state.items()}
    lengths = np.array([16, 9, 0])
    valid = np.arange(16)[None, :] < lengths[:, None]
    xc = x[:, :16]
    jout, jnew = jssm.apply_mamba2_prefill(jmix, jnp.asarray(xc, jd), jstate, jcfg,
                                           valid=jnp.asarray(valid), lengths=jnp.asarray(lengths))
    for use_kernel in (False, True):
        out, new = ssm.apply_mamba2_prefill(tmix, torch.from_numpy(xc).to(td), tstate, cfg,
                                            valid=torch.from_numpy(valid),
                                            lengths=torch.from_numpy(lengths),
                                            use_kernel=use_kernel)
        np.testing.assert_allclose(f32(out)[valid], f32(jout)[valid], **t)
        for k in new:
            assert new[k].dtype == tstate[k].dtype, k
            np.testing.assert_allclose(f32(new[k]), f32(jnew[k]), **t)
        for k in new:  # the idle row keeps its window and state
            np.testing.assert_array_equal(f32(new[k][2]), f32(tstate[k][2]))

    jout, jnew = jssm.apply_mamba2_decode(jmix, jnp.asarray(x[:, :1], jd), jstate, jcfg)
    out, new = ssm.apply_mamba2_decode(tmix, torch.from_numpy(x[:, :1]).to(td), tstate, cfg)
    assert out.shape == (3, 1, cfg.d_model)
    np.testing.assert_allclose(f32(out), f32(jout), **t)
    for k in new:
        np.testing.assert_allclose(f32(new[k]), f32(jnew[k]), **t)
