"""The port's sharding rules (``sharding/``, ``launch/mesh.py``,
``train.optimizer.opt_state_specs``) against the reference's, in one
process with no ranks:

- for each of the eleven configs at full width, shape-only trees (the
  port's ``abstract_params`` on the meta device, the reference's
  ``jax.eval_shape``), on mesh shapes (16, 16) and (2, 16, 16), under
  ``ShardingPolicy()`` and FSDP over each mesh's dp axes: ``param_specs``
  equal leaf for leaf (the reference's stacked layer axis dropped), the
  ``RuleReport`` equal, ``bytes_per_device`` equal to the byte, and
  ``choose_policy`` picking the same policy at the same budgets (the
  reference's rules read only ``mesh.shape``, so a stand-in drives them);
- ``opt_state_specs`` against the reference's for f32 and int8 moments,
  with and without a master copy, on deepseek-v2-236b's tree;
- on the fake backend's 512-rank (2, 16, 16) mesh, every spec of
  deepseek-v2-236b builds meta DTensors whose local shapes add up to
  ``bytes_per_device``;
- ``shard`` outside a rule context returns its argument; the spec
  legality checks; a mesh with no process group raises."""

import functools

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.sharding import rules as jrules
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import opt_state_specs as jopt_state_specs
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import dp_axes, make_test_mesh, mesh_shape, n_chips
from repro_torch.models import Model, ModelRuntime
from repro_torch.sharding import (
    PartitionSpec as P,
    ShardingPolicy,
    bytes_per_device,
    choose_policy,
    distribute_params,
    param_specs,
    shard,
    spec_placements,
)
from repro_torch.sharding.rules import reference_path
from repro_torch.train.optimizer import AdamWConfig, opt_state_specs
from repro_torch.tree import tree_leaves, tree_leaves_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
GiB = 1024 ** 3


class StandIn:
    """What the reference's rules read of a mesh: its ``shape``."""

    def __init__(self, shape):
        self.shape = shape


@functools.lru_cache(maxsize=None)
def shapes(arch: str):
    port = Model(get_arch(arch), ModelRuntime()).abstract_params()
    ref = jax.eval_shape(JModel(jget_arch(arch), JRuntime()).init, jax.random.PRNGKey(0))
    return port, ref


def policies(mesh):
    dp = dp_axes(mesh)
    return [(), ("data",)] + ([dp] if len(dp) > 1 else [])


def port_specs_by_reference_path(port_shapes, specs):
    """The port's spec of each reference leaf: every layer's spec (all
    equal) under the reference's key path."""
    out = {}
    for (path, spec), (_, leaf) in zip(tree_leaves_with_path(specs),
                                       tree_leaves_with_path(port_shapes)):
        ref, _ = reference_path(path, port_shapes)
        assert out.setdefault(ref, (spec, leaf.ndim)) == (spec, leaf.ndim), ref
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_report_and_bytes_match_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    port, ref = shapes(arch)
    for fsdp in policies(mesh):
        ours, our_report = param_specs(port, mesh, ShardingPolicy(fsdp_axes=fsdp))
        theirs, their_report = jrules.param_specs(ref, StandIn(mesh),
                                                  jrules.ShardingPolicy(fsdp_axes=fsdp))
        by_path = port_specs_by_reference_path(port, ours)
        flat = jax.tree_util.tree_flatten_with_path(theirs, is_leaf=lambda s: isinstance(s, JP))[0]
        ref_leaves = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        assert len(flat) == len(by_path)
        for kp, spec in flat:
            path = tuple(k.key for k in kp)
            mine, ndim = by_path[path]
            want = tuple(spec)
            if len(ref_leaves[kp].shape) == ndim + 1:  # a stacked layer axis
                assert want[0] is None, (path, spec)
                want = want[1:]
            assert tuple(mine) == want, (fsdp, path, mine, spec)
        assert our_report.fallbacks == their_report.fallbacks
        assert our_report.ep_layers == their_report.ep_layers
        assert bytes_per_device(port, ours, mesh) == jrules.bytes_per_device(ref, theirs,
                                                                              StandIn(mesh))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "ds-paper-100m", "mixtral-8x7b",
                                  "nemotron-4-340b", "qwen2-72b"])
def test_choose_policy_matches_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    port, ref = shapes(arch)
    multi = "pod" in mesh
    for budget in (2 * GiB, 8 * GiB, 80 * 10 ** 9):
        for mult in (1.0, 5.0):
            ours = choose_policy(port, mesh, hbm_budget_bytes=budget, multi_pod=multi,
                                 state_multiplier=mult)
            theirs = jrules.choose_policy(ref, StandIn(mesh), hbm_budget_bytes=budget,
                                          multi_pod=multi, state_multiplier=mult)
            assert ours.fsdp_axes == theirs.fsdp_axes, (budget, mult)


@pytest.mark.parametrize("moments", ["f32", "int8"])
@pytest.mark.parametrize("master", [False, True])
def test_opt_state_specs_match_reference(moments, master):
    mesh = MESHES["2x16x16"]
    port, ref = shapes("deepseek-v2-236b")  # dense layers, MLA, experts, a shared expert
    pol = ("pod", "data")
    ours = opt_state_specs(param_specs(port, mesh, ShardingPolicy(fsdp_axes=pol))[0],
                           AdamWConfig(moments_dtype=moments, master_fp32=master))
    theirs = jopt_state_specs(
        jrules.param_specs(ref, StandIn(mesh), jrules.ShardingPolicy(fsdp_axes=pol))[0],
        JAdamWConfig(moments_dtype=moments, master_fp32=master))
    assert sorted(ours) == sorted(theirs)
    assert tuple(ours["step"]) == tuple(theirs["step"])
    flat = [(kp, spec) for kp, spec in jax.tree_util.tree_flatten_with_path(
        theirs, is_leaf=lambda s: isinstance(s, JP))[0] if kp[0].key != "step"]
    by_ref = {}
    for path, spec in tree_leaves_with_path(ours):
        if path[0] == "step":
            continue
        # the moments' and master's trees are the parameters' under a key
        # (and, for int8, over {q, scale})
        sub, tail = path[1:], ()
        if moments == "int8" and path[0] in ("mu", "nu"):
            sub, tail = path[1:-1], path[-1:]
        ref_path, _ = reference_path(sub, port)
        by_ref.setdefault((path[0],) + ref_path + tail, spec)
    assert len(flat) == len(by_ref)
    for kp, spec in flat:
        path = tuple(k.key for k in kp)
        mine = tuple(by_ref[path])
        want = tuple(spec)
        if len(want) == len(mine) + 1:
            want = want[1:]
        assert mine == want, (path, mine, spec)


@pytest.fixture
def fake_world():
    """A 512-rank process group on the fake backend, in this process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_production_specs_build_on_512_fake_ranks(fake_world):
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=True, device="cpu")
    assert mesh_shape(mesh) == {"pod": 2, "data": 16, "model": 16} and n_chips(mesh) == 512
    port = Model(get_arch("deepseek-v2-236b"), ModelRuntime(dtype=torch.bfloat16)).abstract_params()
    specs, _ = param_specs(port, mesh, ShardingPolicy(fsdp_axes=("pod", "data")))
    placed = distribute_params(port, mesh, specs)
    local = sum(t.to_local().numel() * t.dtype.itemsize for t in tree_leaves(placed))
    assert local == bytes_per_device(port, specs, mesh)
    assert local < sum(t.numel() * t.dtype.itemsize for t in tree_leaves(port)) // 256


def test_shard_is_a_no_op_without_rules():
    x = torch.ones(2, 3)
    assert shard(x, "batch", "embed") is x


def test_spec_placements_checks_legality():
    mesh = MESHES["2x16x16"]
    pls = spec_placements(P(("pod", "data"), "model"), mesh)
    assert [type(p).__name__ for p in pls] == ["Shard", "Shard", "Shard"]
    assert [p.dim for p in pls] == [0, 0, 1]
    for bad in (P("data", "data"), P("pipe", None), P(("data", "pod"), None)):
        with pytest.raises(ValueError):
            spec_placements(bad, mesh)


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh((1, 1), device="cpu")
