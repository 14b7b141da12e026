"""The port's dry-run arithmetic (``configs.base``'s cells and counts,
``launch.cells``' rules and knobs, ``roofline.analysis``,
``roofline.hbm``) against the reference's, on the same inputs, in one
process with no ranks:

- ``SHAPES``; ``cell_applicable``, ``param_count``,
  ``active_param_count``, ``flops_per_token`` and ``model_flops`` for
  every arch x shape, equal;
- ``pick_microbatches``, ``auto_train_knobs`` and ``make_opt_config``
  per arch, equal;
- ``decode_cell_rules`` and ``cache_specs`` of every applicable decode
  and serving cell at full width on (16, 16) and (2, 16, 16), equal
  (the reference's rules read only ``mesh.shape``: a stand-in drives
  them);
- ``collective_bytes``: each of the five collectives as an HLO line to
  the reference and as a record to the port, at 1e-12;
- ``hbm_traffic``: a hand-written ENTRY computation against the same
  program recorded on meta tensors (reads, writes, an alias read once, a
  quadratic buffer), at 1e-12; the paged kernel's call charged as the
  kernel moves data; the peak of live temporaries;
- ``RooflineResult`` with the H100's rates given to both packages, and
  ``extrapolate``, at 1e-12."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.launch import cells as jcells
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.roofline import analysis as janalysis
from repro.roofline.hbm import hbm_traffic as jhbm_traffic
from repro_torch.configs import SHAPES, cell_applicable, get_arch, list_archs
from repro_torch.kernels import ops
from repro_torch.launch import cells
from repro_torch.launch.mesh import H100
from repro_torch.models import Model, ModelRuntime
from repro_torch.roofline import analysis
from repro_torch.roofline.analysis import CollectiveRecord
from repro_torch.roofline.hbm import hbm_traffic, recording
from repro_torch.tree import tree_leaves_with_path

torch.set_num_threads(1)  # the test workers share the host's cores

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
REL = 1e-12


class StandIn:
    """What the reference's rules read of a mesh: its ``shape``."""

    def __init__(self, shape):
        self.shape = shape


def entries(spec) -> tuple:
    """A spec's entries, a one-axis tuple written as its axis (JAX's
    PartitionSpec normalises ``("data",)`` to ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b), 1.0)


def test_shapes_and_archs_match_reference():
    assert list_archs() == jlist_archs()
    assert list(SHAPES) == list(JSHAPES)
    for name, spec in SHAPES.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(JSHAPES[name])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_cell_counts_match_reference(arch, shape):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert cell_applicable(cfg, SHAPES[shape]) == jcell_applicable(jcfg, JSHAPES[shape])
    assert cfg.uses_subquadratic_attention == jcfg.uses_subquadratic_attention
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    seq = SHAPES[shape].seq_len
    for decode in (False, True):
        assert cfg.flops_per_token(seq, decode=decode) == jcfg.flops_per_token(seq, decode=decode)
    assert analysis.model_flops(cfg, SHAPES[shape]) == janalysis.model_flops(jcfg, JSHAPES[shape])


@pytest.mark.parametrize("arch", list_archs())
def test_train_knobs_match_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for shape in SHAPES:
        assert cells.pick_microbatches(cfg, SHAPES[shape]) == jcells.pick_microbatches(
            jcfg, JSHAPES[shape])
    assert cells.auto_train_knobs(cfg) == jcells.auto_train_knobs(jcfg)
    for moments in ("f32", "int8"):
        for master in (False, True):
            ours = cells.make_opt_config(cfg, moments_dtype=moments, master_fp32=master)
            theirs = jcells.make_opt_config(jcfg, moments_dtype=moments, master_fp32=master)
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


DECODE_KINDS = ("decode", "serve_decode", "serve_paged", "serve_prefill")
DECODE_CELLS = [(a, s) for a in list_archs() for s, spec in SHAPES.items()
                if spec.kind in DECODE_KINDS and cell_applicable(get_arch(a), spec)[0]]


@functools.lru_cache(maxsize=None)
def reference_cache(arch: str, shape: str, model_axis: int):
    """The reference's cache of the cell, shapes only (its build_cell's
    own recipe)."""
    spec, model = JSHAPES[shape], JModel(jget_arch(arch), JRuntime(dtype=jnp.bfloat16))
    b = spec.global_batch
    if spec.kind == "serve_paged":
        n_pages = int(b * (spec.seq_len // jcells.SERVE_PAGE_SIZE)
                      * jcells.SERVE_PAGED_POOL_FRACTION)
        n_pages -= n_pages % model_axis
        return jax.eval_shape(lambda: model.init_cache(
            b, spec.seq_len, dtype=jnp.bfloat16, paged=True,
            page_size=jcells.SERVE_PAGE_SIZE, n_pages=n_pages))
    return jax.eval_shape(lambda: model.init_cache(b, spec.seq_len, dtype=jnp.bfloat16))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_rules_and_cache_specs_match_reference(arch, shape, mesh_name):
    mesh = MESHES[mesh_name]
    rules = cells.decode_cell_rules(mesh, SHAPES[shape])
    jrules = jcells.decode_cell_rules(StandIn(mesh), JSHAPES[shape])
    assert rules == jrules
    model = Model(get_arch(arch), ModelRuntime(dtype=torch.bfloat16))
    ours = cells.cache_specs(model.cfg, cells.cell_cache(model, SHAPES[shape], mesh), rules, mesh)
    jcache = reference_cache(arch, shape, mesh["model"])
    theirs = jcells.cache_specs(jget_arch(arch), jcache, jrules, StandIn(mesh))
    flat = jax.tree_util.tree_flatten_with_path(theirs, is_leaf=lambda s: isinstance(s, JP))[0]
    want = {tuple(k.key for k in kp): entries(s) for kp, s in flat}
    got = {path: entries(s) for path, s in tree_leaves_with_path(ours)}
    assert got == want
    shapes = {tuple(k.key for k in kp): tuple(leaf.shape)
              for kp, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    port_cache = cells.cell_cache(model, SHAPES[shape], mesh)
    assert {p: tuple(t.shape) for p, t in tree_leaves_with_path(port_cache)} == shapes


# ------------------------------------------------------------------ collectives
G16 = "{{" + ",".join(str(i) for i in range(16)) + "}}"
G8 = "{{" + ",".join(str(i) for i in range(8)) + "}}"
COLLECTIVES = {
    # op: (HLO line, the port's record)
    "all-gather": (f"  %ag = bf16[16,1024]{{1,0}} all-gather(bf16[1,1024]{{1,0}} %p0), "
                   f"channel_id=1, replica_groups={G16}, dimensions={{0}}",
                   CollectiveRecord("_c10d_functional.all_gather_into_tensor", 16 * 1024 * 2, 16)),
    "reduce-scatter": ("  %rs = f32[64]{0} reduce-scatter(f32[1024]{0} %p1), "
                       "replica_groups=[32,16]<=[512], dimensions={0}, to_apply=%add",
                       CollectiveRecord("_c10d_functional.reduce_scatter_tensor", 64 * 4, 16)),
    "all-reduce": ("  %ar = f32[256,128]{1,0} all-reduce(f32[256,128]{1,0} %p2), "
                   "replica_groups=[16,32]<=[512], to_apply=%add",
                   CollectiveRecord("_c10d_functional.all_reduce", 256 * 128 * 4, 32)),
    "all-to-all": (f"  %aa = bf16[8,512]{{1,0}} all-to-all(bf16[8,512]{{1,0}} %p3), "
                   f"replica_groups={G8}, dimensions={{0}}",
                   CollectiveRecord("all_to_all_single", 8 * 512 * 2, 8)),
    "collective-permute": ("  %cp = bf16[4,4096]{1,0} collective-permute(bf16[4,4096]{1,0} %p4), "
                           "source_target_pairs={{0,1},{1,0}}",
                           CollectiveRecord("collective-permute", 4 * 4096 * 2, 0)),
}


@pytest.mark.parametrize("ops_", [[op] for op in COLLECTIVES] + [list(COLLECTIVES)],
                         ids=[*COLLECTIVES, "all_five"])
def test_collective_bytes_match_reference(ops_):
    hlo = "\n".join(COLLECTIVES[op][0] for op in ops_)
    theirs = janalysis.collective_bytes(hlo, 512)
    ours = analysis.collective_bytes([COLLECTIVES[op][1] for op in ops_], 512)
    assert ours.count_by_op == theirs.count_by_op
    assert set(ours.bytes_by_op) == set(theirs.bytes_by_op) == set(ops_)
    for op in ops_:
        assert close(ours.bytes_by_op[op], theirs.bytes_by_op[op]), op
    assert close(ours.total_bytes, theirs.total_bytes)


def test_collective_names_map_onto_the_reference_ops():
    for name, op in analysis.C10D_OPS.items():
        assert analysis.reference_op(f"_c10d_functional.{name}.default") == op
    with pytest.raises(ValueError):
        analysis.reference_op("aten.mm")


# ------------------------------------------------------------------ HBM model
ENTRY = """HloModule m

ENTRY %main (x: bf16[128,768], w: bf16[768,768], q: f32[1024,64], k: f32[1024,64], v: f32[1024,64]) -> f32[1024,64] {
  %x = bf16[128,768]{1,0} parameter(0)
  %w = bf16[768,768]{1,0} parameter(1)
  %q = f32[1024,64]{1,0} parameter(2)
  %k = f32[1024,64]{1,0} parameter(3)
  %v = f32[1024,64]{1,0} parameter(4)
  %y = bf16[128,768]{1,0} dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %t = bf16[128,768]{1,0} tanh(%y)
  %z = bf16[128,12,64]{2,1,0} bitcast(%y)
  %u = bf16[128,12,64]{2,1,0} negate(%z)
  %s = f32[1024,1024]{1,0} dot(%q, %k), lhs_contracting_dims={1}, rhs_contracting_dims={1}
  %p = f32[1024,1024]{1,0} fusion(%s), kind=kLoop, calls=%softmax
  ROOT %o = f32[1024,64]{1,0} dot(%p, %v), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_hbm_traffic_matches_reference_on_one_program():
    x, w = meta(128, 768, dtype=torch.bfloat16), meta(768, 768, dtype=torch.bfloat16)
    q, k, v = meta(1024, 64), meta(1024, 64), meta(1024, 64)
    with recording() as rec:
        y = x @ w
        torch.tanh(y)
        torch.neg(y.view(128, 12, 64))  # an alias read once
        s = q @ k.T  # a transposed view read by the product
        p = torch.softmax(s, dim=-1)
        p @ v
    ours, theirs = hbm_traffic(rec.trace), jhbm_traffic(ENTRY)
    assert theirs.quadratic_bytes > 0 and not theirs.has_while
    assert close(ours.bytes_jnp, theirs.bytes_jnp)
    assert close(ours.bytes_flash, theirs.bytes_flash)
    assert close(ours.quadratic_bytes, theirs.quadratic_bytes)
    assert rec.trace.flops == 2 * 128 * 768 * 768 + 2 * 2 * 1024 * 1024 * 64


def test_paged_call_is_charged_as_its_kernel_moves_data():
    b, hkv, g, dk, ps, n_pages, per_row = 8, 2, 3, 64, 16, 64, 8
    qf = meta(b, hkv, g, dk, dtype=torch.bfloat16)
    kp = meta(n_pages, ps, hkv, dk, dtype=torch.bfloat16)
    vp = meta(n_pages, ps, hkv, dk, dtype=torch.bfloat16)
    table, offs = meta(b, per_row, dtype=torch.int32), meta(b, dtype=torch.int32)
    with recording() as rec:
        out = ops.paged_flash_attention_folded(qf, kp, vp, table, offs, tokens_per_row=1)
    moved = sum(t.numel() * t.element_size() for t in (qf, kp, vp, table, offs, out))
    traffic = hbm_traffic(rec.trace)
    assert traffic.bytes_flash == moved
    gathered = b * per_row * ps * hkv * dk * 4  # the plain version's f32 copy of the keys
    assert traffic.bytes_jnp > moved + gathered
    # the card holds the kernel's output only, not the plain version's copies
    assert rec.trace.peak_temp_bytes == out.numel() * out.element_size()


def test_peak_of_live_temporaries():
    x = meta(1024, 256)
    n = x.numel() * x.element_size()
    with recording() as rec:
        a = x + 1
        b = a * 2  # a and b live
        del a
        c = b.view(256, 1024)  # an alias of b: no new storage
        del b
        d = c + 1  # c and d live
        del c, d
    assert rec.trace.peak_temp_bytes == 2 * n


# ------------------------------------------------------------------ roofline core
def test_roofline_result_matches_reference_on_the_h100():
    bytes_by_op = {"all-gather": 3.5e9, "all-reduce": 1.25e9}
    counts = {"all-gather": 12, "all-reduce": 5}
    common = dict(arch="ds-paper-100m", shape="serve_paged_32k", n_layers=12,
                  probe_layers=(2, 4), flops=1.901e11, bytes=7.789e10, bytes_jnp=1.656e12,
                  model_flops_global=1.96e11, n_devices=1)
    ours = analysis.RooflineResult(collective=analysis.CollectiveStats(dict(bytes_by_op),
                                                                       dict(counts)), **common)
    theirs = janalysis.RooflineResult(
        collective=janalysis.CollectiveStats(dict(bytes_by_op), dict(counts)),
        hw=dict(H100, ici_bw=H100["nvlink_bw"]), **common)
    assert ours.hw == H100
    for prop in ("compute_s", "memory_s", "collective_s", "bound_s", "model_flops_per_device",
                 "useful_ratio", "roofline_fraction"):
        assert close(getattr(ours, prop), getattr(theirs, prop)), prop
    assert ours.dominant == theirs.dominant == "memory"
    assert ours.to_json() == theirs.to_json()


def test_extrapolate_matches_reference():
    def probes(mod):
        c1 = mod.ProbeCost(flops=3.704e10, bytes=1.305e10, bytes_jnp=2.761e11,
                           collectives=mod.CollectiveStats({"all-gather": 10.0, "all-reduce": 4.0},
                                                           {"all-gather": 6, "all-reduce": 2}))
        c2 = mod.ProbeCost(flops=6.765e10, bytes=2.602e10, bytes_jnp=5.521e11,
                           collectives=mod.CollectiveStats({"all-gather": 18.0, "all-reduce": 8.0},
                                                           {"all-gather": 10, "all-reduce": 4}))
        return mod.extrapolate(c1, c2, 2, 4, 12)

    ours, theirs = probes(analysis), probes(janalysis)
    for a, b in zip(ours[:3], theirs[:3]):
        assert close(a, b)
    assert ours[3].count_by_op == theirs[3].count_by_op
    assert ours[3].bytes_by_op.keys() == theirs[3].bytes_by_op.keys()
    for op in ours[3].bytes_by_op:
        assert close(ours[3].bytes_by_op[op], theirs[3].bytes_by_op[op])
