"""Dry run: prove the distribution config is coherent, and count each
cell's step (counterpart of the reference package's ``launch/dryrun.py``).

For every applicable (architecture x input shape) cell this script builds
the production step on

  - the single-pod mesh  (16, 16)    ("data", "model")        = 256 ranks
  - the multi-pod mesh   (2, 16, 16) ("pod", "data", "model") = 512 ranks

of the fake backend of ``torch.testing`` (one process plays rank 0 of a
group of the mesh's ranks; its collectives move nothing), runs it once on meta
tensors laid out as DTensors, and records what rank 0 does
(``launch.cells.trace_cell``): whether its state and the step's peak of
temporaries fit the card, its FLOPs and bytes, and its collectives.  With
``--roofline`` it also runs the roofline probes (``roofline.analysis``).

The reference reads XLA's ``memory_analysis()`` and ``cost_analysis()``;
the JSON keys stay its own, filled from the trace:

- ``memory.argument_gib`` the step's inputs, ``output_gib`` its outputs,
  ``alias_gib`` the outputs that are inputs (the cache a decode step
  updates in place), ``temp_gib`` the traced peak of temporaries on the
  card's path (kernels hold their outputs only; the outputs an op made
  are in it), ``per_device_gib`` the inputs plus that peak;
- ``fits`` (the reference's ``fits_16gib``) and ``fits_projected`` (its
  ``fits_16gib_projected``) hold ``per_device_gib`` and ``projected_gib``
  (its ``projected_tpu_gib``: the analytic state bytes plus the traced
  peak of temporaries; no CPU-emulation halving, since nothing is
  emulated, so the two figures coincide) against the card's memory: ``hbm_bytes()`` where a card is
  present, else the data sheet's 80 GB of ``launch.mesh.H100``
  (``card`` names it);
- ``entry_cost.flops`` one rank's FLOPs, ``bytes_accessed`` its traced
  bytes (``roofline.hbm``'s ``bytes_jnp``); ``lower_s`` builds the cell
  and lays its inputs on the mesh, ``compile_s`` runs the traced step.

Usage:
    python -m repro_torch.launch.dryrun --all
    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    python -m repro_torch.launch.dryrun --arch ds-paper-100m --shape serve_paged_32k --roofline
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, cell_applicable, get_arch, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.cells import build_cell, card_bytes, trace_cell
from repro_torch.launch.mesh import H100, make_production_mesh, mesh_shape, n_chips
from repro_torch.roofline.analysis import (
    ProbeCost,
    RooflineResult,
    collective_bytes,
    extrapolate,
    model_flops,
)
from repro_torch.roofline.hbm import hbm_traffic
from repro_torch.sharding.spec import axis_size
from repro_torch.tree import tree_leaves

GiB = 1024 ** 3
@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks on the fake backend, this
    process its rank 0: enough for DeviceMeshes and DTensors of meta
    tensors, whose collectives move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _analytic_arg_bytes(cell, mesh) -> int:
    """Exact per-device bytes of all step inputs (params/opt/cache/batch)
    from their dtypes and specs."""
    total = 0
    for arg, specs in zip(cell.args, cell.in_shardings):
        leaves = tree_leaves(arg)
        spec_leaves = tree_leaves(specs)
        if len(spec_leaves) == 1 and len(leaves) > 1:
            spec_leaves = spec_leaves * len(leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            if not isinstance(leaf, torch.Tensor):
                continue  # the optimizer's step count
            spec = tuple(spec) + (None,) * (leaf.dim() - len(spec))
            n = 1
            for d, ax in zip(leaf.shape, spec):
                n *= -(-d // axis_size(mesh, ax))
            total += n * leaf.element_size()
    return total


def probe_layer_pair(cfg: ArchConfig) -> Tuple[int, Optional[int]]:
    """Reduced depths for the differencing probes."""
    if cfg.family == "hybrid":
        e = cfg.shared_attn_every
        return e, 2 * e
    if cfg.family == "moe" and cfg.first_k_dense:
        return cfg.first_k_dense + 1, cfg.first_k_dense + 3
    if cfg.n_layers <= 6:
        return cfg.n_layers, None  # small enough: run exactly
    return 2, 4


def _mesh(multi_pod: bool, mesh):
    if mesh is not None:
        return mesh, "x".join(str(s) for s in mesh_shape(mesh).values())
    return (make_production_mesh(multi_pod=multi_pod, device="cpu"),
            "2x16x16" if multi_pod else "16x16")


def ranks(multi_pod: bool) -> int:
    """The world a production mesh takes: 512 ranks for the multi-pod mesh,
    256 for the single-pod one."""
    return 512 if multi_pod else 256


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *, mesh=None,
             cfg_override: Optional[ArchConfig] = None, verbose: bool = True) -> Dict:
    """Build and trace one cell.  ``mesh`` (a ``DeviceMesh`` or a mapping
    ``{axis: size}`` of one rank) takes the place of the production mesh,
    which needs a group of its ranks (:func:`fake_world`, :func:`ranks`)."""
    mesh, mesh_name = _mesh(multi_pod, mesh)
    cfg = cfg_override or get_arch(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, mesh, cfg_override=cfg_override)
    traced = trace_cell(cell, mesh)
    result = cell_report(cell, traced, mesh, time.perf_counter() - t0)
    if verbose:
        mem = result["memory"]
        print(
            f"[dryrun] {arch:18s} {shape_name:12s} {mesh_name:8s} "
            f"trace={traced.seconds:6.1f}s mem/dev={mem['per_device_gib']:7.2f}GiB "
            f"proj={mem['projected_gib']:6.2f}GiB fits={'Y' if mem['fits_projected'] else 'N'} "
            f"colls={sum(result['collective_counts'].values())}"
        )
    return result


def cell_report(cell, traced, mesh, seconds: float) -> Dict:
    """``run_cell``'s record of a built and traced cell (``seconds`` the
    build and the trace together)."""
    _, mesh_name = _mesh(False, mesh)
    tr = traced.recorder.trace
    hbm = hbm_traffic(tr)
    state_bytes = _analytic_arg_bytes(cell, mesh)
    # the peak of temporaries holds the outputs an op made; an aliased
    # output is an input the step updated in place, counted in the state
    projected = state_bytes + tr.peak_temp_bytes
    per_dev = projected
    limit = card_bytes()
    colls = collective_bytes(tr.collectives, n_chips(mesh))
    return {
        "arch": cell.arch,
        "shape": cell.shape.name,
        "mesh": mesh_name,
        "status": "ok",
        "policy": {"fsdp_axes": list(cell.policy.fsdp_axes), "tp_axis": cell.policy.tp_axis},
        "microbatches": cell.microbatches,
        "lower_s": round(seconds - traced.seconds, 2),
        "compile_s": round(traced.seconds, 2),
        "memory": {
            "argument_gib": state_bytes / GiB,
            "output_gib": traced.output_bytes / GiB,
            "temp_gib": tr.peak_temp_bytes / GiB,
            "alias_gib": traced.alias_bytes / GiB,
            "per_device_gib": per_dev / GiB,
            "fits": per_dev <= limit,
            "state_gib_analytic": state_bytes / GiB,
            "projected_gib": projected / GiB,
            "fits_projected": projected <= limit,
            "card_gib": limit / GiB,
            "card": H100["card"] if not torch.cuda.is_available()
            else torch.cuda.get_device_name(0),
        },
        "entry_cost": {"flops": tr.flops, "bytes_accessed": hbm.bytes_jnp},
        "collective_counts": colls.count_by_op,
    }


def probe_cost(traced, mesh) -> ProbeCost:
    """A traced cell's count: one rank's FLOPs, HBM bytes and collectives."""
    tr = traced.recorder.trace
    hbm = hbm_traffic(tr)
    return ProbeCost(
        flops=tr.flops,
        bytes=hbm.bytes_flash,
        collectives=collective_bytes(tr.collectives, n_chips(mesh)),
        bytes_jnp=hbm.bytes_jnp,
        quadratic_bytes=hbm.quadratic_bytes,
    )


def cell_roofline(cell, traced, mesh) -> RooflineResult:
    """The roofline of a cell from its own trace at its own depth (no
    probes: the port is eager, so the direct count is whole)."""
    c = probe_cost(traced, mesh)
    n = cell.cfg.n_layers
    return RooflineResult(arch=cell.arch, shape=cell.shape.name, n_layers=n, probe_layers=(n, n),
                          flops=c.flops, bytes=c.bytes, bytes_jnp=c.bytes_jnp,
                          collective=c.collectives,
                          model_flops_global=model_flops(cell.cfg, cell.shape),
                          n_devices=n_chips(mesh))


def run_probe(arch: str, shape_name: str, layers: int, policy, *, mesh=None,
              cfg: Optional[ArchConfig] = None) -> ProbeCost:
    """One probe: the cell at ``layers`` layers on the single-pod mesh
    (or ``mesh``), plain attention, one microbatch."""
    mesh, _ = _mesh(False, mesh)
    cfg = dataclasses.replace(cfg or get_arch(arch), n_layers=layers)
    cell = build_cell(arch, shape_name, mesh, cfg_override=cfg, attn_impl="direct",
                      unroll_layers=True, microbatches=1, policy=policy)
    return probe_cost(trace_cell(cell, mesh), mesh)


def run_roofline(arch: str, shape_name: str, *, mesh=None, cfg: Optional[ArchConfig] = None,
                 verbose: bool = True) -> Dict:
    cfg = cfg or get_arch(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": reason}
    mesh, _ = _mesh(False, mesh)
    # the probes take the production cell's sharding policy
    policy = build_cell(arch, shape_name, mesh, cfg_override=cfg).policy
    l1, l2 = probe_layer_pair(cfg)
    c1 = run_probe(arch, shape_name, l1, policy, mesh=mesh, cfg=cfg)
    if l2 is None:
        flops, bytes_, bytes_jnp, coll = c1.flops, c1.bytes, c1.bytes_jnp, c1.collectives
        pair = (l1, l1)
    else:
        c2 = run_probe(arch, shape_name, l2, policy, mesh=mesh, cfg=cfg)
        flops, bytes_, bytes_jnp, coll = extrapolate(c1, c2, l1, l2, cfg.n_layers)
        pair = (l1, l2)
    rr = RooflineResult(
        arch=arch,
        shape=shape_name,
        n_layers=cfg.n_layers,
        probe_layers=pair,
        flops=flops,
        bytes=bytes_,
        bytes_jnp=bytes_jnp,
        collective=coll,
        model_flops_global=model_flops(cfg, shape),
        n_devices=n_chips(mesh),
    )
    out = {"status": "ok", **rr.to_json()}
    if verbose:
        print(
            f"[roofline] {arch:18s} {shape_name:12s} "
            f"compute={rr.compute_s * 1e3:9.3f}ms memory={rr.memory_s * 1e3:9.3f}ms "
            f"coll={rr.collective_s * 1e3:9.3f}ms dom={rr.dominant:10s} "
            f"useful={rr.useful_ratio:5.2f} frac={rr.roofline_fraction:5.2f}"
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--roofline", action="store_true", help="also run roofline probes")
    ap.add_argument("--roofline-only", action="store_true")
    ap.add_argument("--out", default="experiments")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else [a for a in list_archs() if a != "ds-paper-100m"]
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(os.path.join(args.out, "dryrun"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "roofline"), exist_ok=True)

    failures = []
    for arch in archs:
        for shape in shapes:
            if not args.roofline_only:
                meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
                for multi in meshes:
                    mesh_name = "2x16x16" if multi else "16x16"
                    path = os.path.join(args.out, "dryrun", f"{arch}__{shape}__{mesh_name}.json")
                    try:
                        with fake_world(ranks(multi)):
                            res = run_cell(arch, shape, multi)
                    except Exception as e:  # noqa: BLE001  (recorded, the run goes on)
                        res = {
                            "arch": arch, "shape": shape, "mesh": mesh_name,
                            "status": "error", "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc(limit=8),
                        }
                        failures.append((arch, shape, mesh_name, str(e)))
                        print(f"[dryrun] {arch} {shape} {mesh_name} FAILED: {e}")
                    with open(path, "w") as f:
                        json.dump(res, f, indent=2)
            if args.roofline or args.roofline_only:
                path = os.path.join(args.out, "roofline", f"{arch}__{shape}.json")
                try:
                    with fake_world(ranks(False)):
                        res = run_roofline(arch, shape)
                except Exception as e:  # noqa: BLE001  (recorded, the run goes on)
                    res = {
                        "arch": arch, "shape": shape, "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc(limit=8),
                    }
                    failures.append((arch, shape, "roofline", str(e)))
                    print(f"[roofline] {arch} {shape} FAILED: {e}")
                with open(path, "w") as f:
                    json.dump(res, f, indent=2)

    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nall requested cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
