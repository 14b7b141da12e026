"""Rank groups for the port's mesh tests: ``spawn`` runs a function on N
CPU processes joined over gloo, and the rank bodies of
``test_torch_distribution.py``, ``test_torch_mesh_families.py``,
``test_torch_moe_shardmap.py`` and ``test_torch_pipeline.py`` live here, so the spawned processes import
torch and the port alone (the test files import JAX as well).

Each group rendezvouses through a ``FileStore`` under the test's
temporary directory (no port, so xdist workers never collide), runs one
thread a rank and has a deadline: a rank that fails writes its traceback
and the group fails; a group past its deadline is killed and fails.
Inputs and results cross as ``torch.save`` files in that directory.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist


def _entry(fn, rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), world),
                                rank=rank, world_size=world)
        try:
            fn(rank, world, Path(root))
        finally:
            dist.destroy_process_group()
    except BaseException:
        Path(root, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def start(fn, world: int, root: Path) -> list:
    """``fn(rank, world, root)`` on ``world`` spawned processes, started."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(root))) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs: list, root: Path, timeout: float = 150.0) -> None:
    """Wait for a group from :func:`start`; raises with the first failing
    rank's traceback, or when the group outlives ``timeout`` seconds
    (every rank is then killed)."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    errs = sorted(root.glob("rank*.err"))
    if errs:
        raise AssertionError(f"{errs[0].name}:\n{errs[0].read_text()}")
    if hung:
        raise AssertionError(f"{len(hung)} of {len(procs)} ranks still running after {timeout} s")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    assert not bad, f"ranks exited with {bad}"


def spawn(fn, world: int, root: Path, timeout: float = 150.0) -> None:
    """:func:`start` then :func:`join`."""
    join(start(fn, world, root), root, timeout)


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


# ------------------------------------------------------------ distribution
def distribution_rank(rank: int, world: int, root: Path) -> None:
    """8 ranks on a (2, 4) ("data", "model") mesh, FSDP over "data" under
    ``train_rules``: the sharded loss of each model in ``inputs.pt``, the
    gradient of the first, one AdamW step with the state laid out by
    ``opt_state_specs`` beside the unsharded step, and the kernel ops on
    DTensors beside their plain calls."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd import ssd_on_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.transformer import Model, ModelRuntime
    from repro_torch.sharding import (
        PartitionSpec as P,
        ShardingPolicy,
        axis_rules,
        distribute_params,
        param_specs,
        spec_placements,
        train_rules,
    )
    from repro_torch.train.optimizer import (
        AdamWConfig,
        adamw_update,
        adamw_update_,
        init_opt_state,
        opt_state_specs,
    )
    from repro_torch.train.steps import _value_and_grad
    from repro_torch.tree import tree_map

    inputs = torch.load(root / "inputs.pt")
    out = {}
    try:
        make_test_mesh((2, 2), ("data", "model"), device="cpu")
    except ValueError as e:
        out["wrong_world"] = str(e)
    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    rules = train_rules(multi_pod=False)
    batch_pl = spec_placements(P("data", None), mesh)

    def place(case):
        model = Model(reduced(get_arch(case["arch"])), ModelRuntime())
        specs, _ = param_specs(case["params"], mesh, ShardingPolicy(fsdp_axes=("data",)))
        ps = distribute_params(case["params"], mesh, specs)
        bs = {k: distribute_tensor(v, mesh, batch_pl) for k, v in case["batch"].items()}
        return model, specs, ps, bs

    def loss_fn(model):
        def fn(p, b):
            with axis_rules(mesh, rules):
                return model.loss(p, b)
        return fn

    for name, case in inputs["losses"].items():
        model, _, ps, bs = place(case)
        out[f"loss/{name}"] = float(_full(loss_fn(model)(ps, bs)[0]))

    model, specs, ps, bs = place(inputs["grads"])
    loss, grads = _value_and_grad(loss_fn(model), ps, bs)
    out["grads"] = tree_map(_full, grads)
    out["grad_placements_match"] = all(
        tuple(g.placements) == tuple(p.placements)
        for g, p in zip(_leaves(grads), _leaves(ps)))

    g = torch.Generator().manual_seed(5)
    for name, ocfg in (("f32", AdamWConfig()), ("master", AdamWConfig(master_fp32=True))):
        params = inputs["grads"]["params"]
        state = init_opt_state(params, ocfg)
        state["mu"] = tree_map(lambda t: 0.01 * torch.randn(t.shape, generator=g), state["mu"])
        state["nu"] = tree_map(lambda t: 0.01 * torch.rand(t.shape, generator=g), state["nu"])
        state["step"] = 3
        ospecs = opt_state_specs(specs, ocfg)
        sharded = {k: v if k == "step" else distribute_params(v, mesh, ospecs[k])
                   for k, v in state.items()}
        new_p, new_s, _ = adamw_update(ps, grads, sharded, ocfg)
        ref_p, ref_s, _ = adamw_update(params, out["grads"], state, ocfg)
        out[f"adamw/{name}"] = {
            "sharded": tree_map(_full, {"params": new_p, "mu": new_s["mu"], "nu": new_s["nu"]}),
            "plain": {"params": ref_p, "mu": ref_s["mu"], "nu": ref_s["nu"]},
            "laid_out": all(tuple(a.placements) == tuple(b.placements)
                            for a, b in zip(_leaves(new_s["mu"]), _leaves(sharded["mu"]))),
        }
        # the same step donated: written into the DTensors it was given
        d_p = tree_map(lambda t: t.clone(), ps)
        d_s = {k: v if k == "step" else tree_map(lambda t: t.clone(), v)
               for k, v in sharded.items()}
        placements = [tuple(t.placements) for t in _leaves((d_p, d_s["mu"], d_s["nu"]))]
        got_p, got_s, _ = adamw_update_(d_p, tree_map(lambda t: t, grads), d_s, ocfg)
        out[f"adamw_donated/{name}"] = {
            "donated": tree_map(_full, {"params": got_p, "mu": got_s["mu"], "nu": got_s["nu"]}),
            "functional": out[f"adamw/{name}"]["sharded"],
            "in_place": got_p is d_p and got_s is d_s and got_s["step"] == new_s["step"],
            "laid_out": placements == [tuple(t.placements)
                                       for t in _leaves((got_p, got_s["mu"], got_s["nu"]))],
        }

    # the kernel ops take DTensors through local_map: each rank runs the
    # plain version on its shard here
    k = inputs["ops"]
    rep = spec_placements(P(), mesh)
    with axis_rules(mesh, rules):
        def dt(t, spec):
            return distribute_tensor(t, mesh, spec_placements(spec, mesh))

        q, kk, v = (dt(t, P("data", None, "model", None)) for t in k["qkv"])
        out["ops/flash"] = (_full(ops.flash_attention(q, kk, v, causal=True)),
                            ops.flash_attention(*k["qkv"], causal=True))
        x = dt(k["norm_x"], P("data", None, None)).requires_grad_(True)
        w = distribute_tensor(k["norm_w"], mesh, rep).requires_grad_(True)
        y = ops.rmsnorm(x, w, eps=1e-5)
        gx, gw = torch.autograd.grad((y * dt(k["norm_dy"], P("data", None, None))).sum(), (x, w))
        xr, wr = k["norm_x"].clone().requires_grad_(True), k["norm_w"].clone().requires_grad_(True)
        yr = ops.rmsnorm(xr, wr, eps=1e-5)
        gxr, gwr = torch.autograd.grad((yr * k["norm_dy"]).sum(), (xr, wr))
        out["ops/rmsnorm"] = ((_full(y), _full(gx), _full(gw)), (yr, gxr, gwr))
        pq, kp, vp, table, offs = k["paged"]
        dq = dt(pq, P("data", None, "model", None))
        out["ops/paged"] = (
            _full(ops.paged_attention(dq, distribute_tensor(kp, mesh, rep),
                                      distribute_tensor(vp, mesh, rep),
                                      distribute_tensor(table, mesh, rep),
                                      distribute_tensor(offs, mesh, rep))),
            ops.paged_attention(pq, kp, vp, table, offs))
        sx, sdt, sA, sB, sC = k["ssd"]
        y_d, s_d = ssd_on_mesh(ssd_chunked, dt(sx, P("data", None, "model", None)),
                                   dt(sdt, P("data", None, "model")),
                                   distribute_tensor(sA, mesh, rep), dt(sB, P("data", None, None)),
                                   dt(sC, P("data", None, None)), chunk=16)
        out["ops/ssd"] = ((_full(y_d), _full(s_d)), ssd_chunked(sx, sdt, sA, sB, sC, chunk=16))
    if rank == 0:
        torch.save(out, root / "out.pt")


def _leaves(tree):
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


# ------------------------------------------------------- every family
def families_rank(rank: int, world: int, root: Path) -> None:
    """4 ranks on a (2, 2) ("data", "model") mesh, FSDP over "data" under
    ``train_rules``: each reduced model's loss in ``inputs.pt`` with every
    parameter and the batch (tokens, labels, stub frames or patches) laid
    out as DTensors."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import Model, ModelRuntime
    from repro_torch.sharding import (
        PartitionSpec as P,
        ShardingPolicy,
        axis_rules,
        distribute_params,
        param_specs,
        spec_placements,
        train_rules,
    )

    inputs = torch.load(root / "inputs.pt")
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for arch, case in inputs.items():
        model = Model(reduced(get_arch(arch)), ModelRuntime())
        specs, _ = param_specs(case["params"], mesh, ShardingPolicy(fsdp_axes=("data",)))
        ps = distribute_params(case["params"], mesh, specs)
        bs = {k: distribute_tensor(v, mesh, spec_placements(P("data", *[None] * (v.dim() - 1)),
                                                             mesh))
              for k, v in case["batch"].items()}
        with axis_rules(mesh, train_rules(multi_pod=False)):
            out[arch] = float(_full(model.loss(ps, bs)[0]))
    if rank == 0:
        torch.save(out, root / "out.pt")


# ------------------------------------------------------------------ MoE
def moe_rank(rank: int, world: int, root: Path) -> None:
    """8 ranks on (2, 4): ``apply_moe(..., "shardmap")`` under
    ``train_rules`` with the reference test's weight specs, its gradients
    through ``sum(y ** 2)``, and the capacity-0.6 case that drops."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models.moe_shardmap import shardmap_applicable
    from repro_torch.sharding import PartitionSpec as P
    from repro_torch.sharding import axis_rules, spec_placements, train_rules

    inputs = torch.load(root / "inputs.pt")
    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    cfg = dataclasses.replace(reduced(get_arch("mixtral-8x7b")), **inputs["cfg"])
    wspecs = {"router": P("data", None), "wi": P("model", "data", None),
              "wg": P("model", "data", None), "wo": P("model", "data", None)}
    ps = {k: distribute_tensor(v, mesh, spec_placements(wspecs[k], mesh)).requires_grad_(True)
          for k, v in inputs["p"].items()}
    xs = distribute_tensor(inputs["x"], mesh, spec_placements(P("data", None, None), mesh))
    out = {}
    with axis_rules(mesh, train_rules(multi_pod=False)):
        out["applicable"] = shardmap_applicable(cfg, xs.shape)
        y = moe.apply_moe(ps, xs, cfg, "shardmap")
        grads = torch.autograd.grad((y ** 2).sum(), [ps[k] for k in wspecs])
        cfg2 = dataclasses.replace(cfg, capacity_factor=0.6)
        y2 = moe.apply_moe(ps, xs, cfg2, "shardmap")
    out["y"] = _full(y).detach()
    out["grads"] = {k: _full(g) for k, g in zip(wspecs, grads)}
    out["y_drop"] = _full(y2).detach()
    if rank == 0:
        torch.save(out, root / "out.pt")


# ------------------------------------------------------------- pipeline
def pipeline_rank(rank: int, world: int, root: Path) -> None:
    """4 ranks on ("pipe",): ``pipeline_apply`` with the stages' stack
    whole on every rank, and laid out one stage a rank as DTensors."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.pipeline import pipeline_apply

    inputs = torch.load(root / "inputs.pt")
    mesh = make_test_mesh((world,), ("pipe",), device="cpu")

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    params = {"w": inputs["w"], "b": inputs["b"]}
    out = {"whole": pipeline_apply(mesh, params, inputs["x"], stage_fn)}
    sharded = {k: distribute_tensor(v, mesh, [Shard(0)]) for k, v in params.items()}
    out["dtensor"] = _full(pipeline_apply(mesh, sharded, inputs["x"], stage_fn))
    if rank == 0:
        torch.save(out, root / "out.pt")
