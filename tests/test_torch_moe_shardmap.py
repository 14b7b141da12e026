"""The port's expert-parallel MoE (``models/moe_shardmap.py``) on 8 CPU
ranks (gloo, a (2, 4) ("data", "model") mesh under ``train_rules``) with
the reference test's config (d_model 32, moe_d_ff 64, 8 experts, top-k
2) and weight specs (``tests/test_moe_shardmap.py``):

- its output at 2e-5 of the reference's ``apply_moe(..., "dense")`` at
  capacity factor 16 (no drops);
- the ``router``, ``wi``, ``wg`` and ``wo`` gradients of ``sum(y ** 2)``
  at 1e-4 of ``jax.grad`` through the dense oracle;
- at capacity factor 0.6, where entries drop, its output at 2e-5 of the
  reference's own ``shardmap`` output on 8 forced host devices (run in a
  subprocess, as the reference's test runs it): the local drop rule is
  the same;
- without rules, ``shardmap`` is the gather path.

The ranks (``torch_mesh_ranks.moe_rank``) import torch and the port
alone."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.moe import apply_moe as japply_moe
from repro.models.moe import moe_init
from repro_torch.configs import get_arch, reduced
from repro_torch.models import moe
from repro_torch.models.moe_shardmap import shardmap_applicable
from torch_mesh_ranks import join, moe_rank, start

torch.set_num_threads(1)  # the test workers share the host's cores

CFG = dict(d_model=32, moe_d_ff=64, n_experts=8, top_k=2, capacity_factor=16.0)
SRC = str(Path(__file__).resolve().parents[1] / "src")

# the reference's shardmap at capacity 0.6 on 8 forced host devices
DROP_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch, reduced
from repro.models.moe import apply_moe
from repro.sharding.logical import axis_rules, train_rules
from repro.launch.mesh import make_test_mesh

mesh = make_test_mesh((2, 4), ("data", "model"))
cfg = dataclasses.replace(reduced(get_arch("mixtral-8x7b")), d_model=32, moe_d_ff=64,
                          n_experts=8, top_k=2, capacity_factor=0.6)
z = np.load(sys.argv[1])
p = {k: jnp.asarray(z[k]) for k in ("router", "wi", "wg", "wo")}
wspecs = {"router": P("data", None), "wi": P("model", "data", None),
          "wg": P("model", "data", None), "wo": P("model", "data", None)}
p_sh = {k: jax.device_put(p[k], NamedSharding(mesh, wspecs[k])) for k in p}
x_sh = jax.device_put(jnp.asarray(z["x"]), NamedSharding(mesh, P("data", None, None)))
def run(pp, xx):
    with axis_rules(mesh, train_rules(multi_pod=False)):
        return apply_moe(pp, xx, cfg, "shardmap")
with jax.set_mesh(mesh):
    out = jax.jit(run)(p_sh, x_sh)
np.save(sys.argv[2], np.asarray(out))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    cfg = dataclasses.replace(jreduced(jget_arch("mixtral-8x7b")), **CFG)
    p = moe_init(jax.random.PRNGKey(0), cfg, jnp.float32, 0.1)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
    np.savez(root / "in.npz", x=np.asarray(x), **{k: np.asarray(v) for k, v in p.items()})
    env = dict(os.environ, PYTHONPATH=SRC)
    drop = subprocess.Popen([sys.executable, "-c", DROP_SCRIPT, str(root / "in.npz"),
                             str(root / "drop.npy")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        torch.save({"cfg": CFG, "x": torch.from_numpy(np.array(x)),
                    "p": {k: torch.from_numpy(np.array(v)) for k, v in p.items()}},
                   root / "inputs.pt")
        ranks = start(moe_rank, 8, root)
        try:  # the reference's numbers while the ranks run
            ref = {"y": np.asarray(japply_moe(p, x, cfg, "dense")),
                   "grads": jax.grad(lambda q: jnp.sum(japply_moe(q, x, cfg, "dense") ** 2))(p)}
        finally:
            join(ranks, root)
        _, err = drop.communicate(timeout=300)
    finally:
        if drop.poll() is None:
            drop.kill()
            drop.communicate()
    assert drop.returncode == 0, err[-3000:]
    ref["y_drop"] = np.load(root / "drop.npy")
    return ref, torch.load(root / "out.pt")


def test_shardmap_output_matches_dense(run):
    ref, out = run
    assert out["applicable"]
    np.testing.assert_allclose(out["y"].numpy(), ref["y"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("leaf", ["router", "wi", "wg", "wo"])
def test_shardmap_gradients_match_jax_grad(run, leaf):
    ref, out = run
    np.testing.assert_allclose(out["grads"][leaf].numpy(), np.asarray(ref["grads"][leaf]),
                               rtol=1e-4, atol=1e-4)


def test_dropping_capacity_matches_reference_shardmap(run):
    """At capacity 0.6 entries drop (the output leaves the dense oracle),
    and each rank drops the same entries as the reference's."""
    ref, out = run
    assert np.max(np.abs(ref["y_drop"] - ref["y"])) > 1e-2
    np.testing.assert_allclose(out["y_drop"].numpy(), ref["y_drop"], rtol=2e-5, atol=2e-5)


def test_shardmap_without_rules_is_the_gather_path():
    cfg = reduced(get_arch("mixtral-8x7b"))
    g = torch.Generator().manual_seed(0)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": torch.randn(d, e, generator=g), "wi": torch.randn(e, d, f, generator=g),
         "wg": torch.randn(e, d, f, generator=g), "wo": torch.randn(e, f, d, generator=g)}
    x = torch.randn(2, 8, d, generator=g)
    assert not shardmap_applicable(cfg, x.shape)
    torch.testing.assert_close(moe.apply_moe(p, x, cfg, "shardmap"),
                               moe.apply_moe_gather(p, x, cfg), rtol=0, atol=0)
