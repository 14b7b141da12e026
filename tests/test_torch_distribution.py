"""The port over a mesh of 8 CPU ranks (gloo, a (2, 4) ("data", "model")
mesh, FSDP over "data" under ``train_rules``, as the reference's
``tests/test_distribution.py``) against the reference run unsharded:

- the sharded loss of reduced ``ds-paper-100m`` and ``mamba2-1.3b`` at
  1e-4 of the reference's ``model.loss``;
- every leaf of ``ds-paper-100m``'s sharded gradient at 1e-4 of
  ``jax.grad``, each laid out as its parameter;
- one AdamW step over DTensors with the state laid out by
  ``opt_state_specs`` equal to the port's unsharded step at 1e-6;
- the kernel ops (flash, paged, RMSNorm and its gradient, the SSD scan)
  on DTensors through ``local_map`` equal to their plain calls;
- a mesh that does not match the world size raises;
- the rules engine's specs for every reduced arch on (2, 4): legal
  placements, and FSDP holding fewer bytes a device than pure TP.

The JAX side runs here; the ranks (``torch_mesh_ranks.distribution_rank``)
import torch and the port alone."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model, ModelRuntime
from repro_torch.models.weights import params_from_jax, params_to_jax
from repro_torch.sharding import ShardingPolicy, bytes_per_device, param_shardings, param_specs
from repro_torch.tree import tree_leaves, tree_leaves_with_path
from torch_mesh_ranks import distribution_rank, join, start

torch.set_num_threads(1)  # the test workers share the host's cores

MESH = {"data": 2, "model": 4}
LOSS_ARCHS = ("ds-paper-100m", "mamba2-1.3b")


def _case(arch: str, seed: int, tok_seed: int):
    jm = JModel(jreduced(jget_arch(arch)), JRuntime())
    jp = jm.init(jax.random.PRNGKey(seed))
    toks = np.random.default_rng(tok_seed).integers(0, jm.cfg.vocab_size, (4, 32))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    return jm, jp, batch


def _port(arch, jp, batch):
    return {"arch": arch, "params": params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}


def _ops_inputs():
    rng = np.random.default_rng(3)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    n_pages, ps = 12, 4
    table = torch.from_numpy(rng.permutation(n_pages)[:8].reshape(4, 2).astype(np.int32))
    return {
        "qkv": [f(2, 32, 4, 64) for _ in range(3)],
        "norm_x": f(4, 8, 64), "norm_w": f(64), "norm_dy": f(4, 8, 64),
        "paged": [f(4, 1, 8, 64), f(n_pages, ps, 4, 64), f(n_pages, ps, 4, 64), table,
                  torch.tensor([3, 7, 0, 5], dtype=torch.int32)],
        "ssd": [f(2, 32, 4, 16), torch.nn.functional.softplus(f(2, 32, 4)),
                -torch.exp(f(4)), f(2, 32, 16), f(2, 32, 16)],
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's numbers and the ranks' results, from one group."""
    root = tmp_path_factory.mktemp("mesh")
    cases = {arch: _case(arch, 0, 1) for arch in LOSS_ARCHS}  # the reference test's seeds
    grad_case = _case("ds-paper-100m", 2, 3)
    inputs = {"losses": {arch: _port(arch, jp, batch) for arch, (_, jp, batch) in cases.items()},
              "grads": _port("ds-paper-100m", *grad_case[1:]), "ops": _ops_inputs()}
    torch.save(inputs, root / "inputs.pt")
    ranks = start(distribution_rank, 8, root)
    try:  # the reference's numbers while the ranks run
        jm, jp, batch = grad_case
        ref = {"loss": {arch: float(m.loss(p, b)[0]) for arch, (m, p, b) in cases.items()},
               "grads": jax.grad(lambda q: jm.loss(q, batch)[0])(jp)}
    finally:
        join(ranks, root)
    return ref, torch.load(root / "out.pt")


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_loss_matches_reference(run, arch):
    ref, out = run
    assert abs(out[f"loss/{arch}"] - ref["loss"][arch]) < 1e-4, (out[f"loss/{arch}"],
                                                               ref["loss"][arch])


def test_sharded_grads_match_jax_grad(run):
    """Every leaf, in the reference's layout, within 1e-4 of ``jax.grad``
    (the reference test's bound); each gradient laid out as its
    parameter."""
    ref, out = run
    assert out["grad_placements_match"]
    mine = params_to_jax(out["grads"])
    flat_ref = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    flat_mine = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert len(flat_ref) == len(flat_mine)
    for path, g in flat_ref:
        err = float(np.max(np.abs(np.asarray(flat_mine[path]) - np.asarray(g))))
        assert err < 1e-4, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("name", ["f32", "master"])
def test_sharded_adamw_step_equals_unsharded(run, name):
    _, out = run
    res = out[f"adamw/{name}"]
    assert res["laid_out"]
    for part in ("params", "mu", "nu"):
        for (path, a), b in zip(tree_leaves_with_path(res["sharded"][part]),
                                tree_leaves(res["plain"][part])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=f"{part} {path}")


@pytest.mark.parametrize("name", ["f32", "master"])
def test_donated_adamw_on_dtensors_is_the_functional_step(run, name):
    """``adamw_update_`` on the same DTensors: written in place, laid out
    as before, bit for bit the functional update over the mesh."""
    _, out = run
    res = out[f"adamw_donated/{name}"]
    assert res["in_place"] and res["laid_out"]
    for part in ("params", "mu", "nu"):
        for (path, a), b in zip(tree_leaves_with_path(res["donated"][part]),
                                tree_leaves(res["functional"][part])):
            assert torch.equal(a, b), f"{part} {path}"


@pytest.mark.parametrize("op", ["flash", "rmsnorm", "paged", "ssd"])
def test_kernel_ops_on_dtensors_equal_plain(run, op):
    _, out = run
    got, want = out[f"ops/{op}"]
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_mesh_of_another_size_raises(run):
    _, out = run
    assert "holds 4 ranks, the world has 8" in out["wrong_world"]


@pytest.mark.parametrize("arch", list_archs())
def test_reduced_specs_legal_and_fsdp_smaller(arch):
    """The reference test's first part: on (2, 4) every spec becomes legal
    placements and FSDP over "data" holds fewer bytes a device."""
    shapes = Model(reduced(get_arch(arch)), ModelRuntime()).abstract_params()
    tp, _ = param_specs(shapes, MESH, ShardingPolicy())
    fsdp, _ = param_specs(shapes, MESH, ShardingPolicy(fsdp_axes=("data",)))
    assert bytes_per_device(shapes, fsdp, MESH) < bytes_per_device(shapes, tp, MESH)
    # building a NamedSharding checks its spec against the mesh, as the
    # reference's does
    shardings, _ = param_shardings(shapes, MESH, ShardingPolicy(fsdp_axes=("data",)))
    assert [s.spec for s in tree_leaves(shardings)] == tree_leaves(fsdp)
