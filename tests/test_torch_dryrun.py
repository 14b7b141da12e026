"""The port's dry run held to itself on the fake backend's ranks, in this
process (``torch.testing``'s fake process group: DTensors of meta
tensors, collectives that move nothing):

- the reference dry-run test's three small cells (``tests/
  test_dryrun_cells.py``: a train, a MoE decode and an SSM long-context
  cell) built and traced on 8 ranks in a (2, 4) ("data", "model") mesh:
  the analytic state bytes equal the local shards DTensor lays out (the
  parameters' ``bytes_per_device`` plus the optimizer state, the cache
  and the batch), the traced bytes are positive, and a cell that shards
  moves bytes between ranks;
- the probes' extrapolation from 2 and 4 layers of an 8-layer reduced
  ds-paper-100m equal to the direct count at 8 (FLOPs, bytes,
  collectives);
- ``run_cell`` on a one-rank mapping (the card's layout) and the CLI on
  the fake backend's 256 and 512 ranks for ds-paper-100m's
  ``serve_paged_32k``, writing the reference's JSON keys with ``fits``
  for ``fits_16gib``;
- a train cell donates its parameters and optimizer state, as the
  reference's does: traced donated, its step's outputs are its inputs and
  its peak of temporaries is lower than the functional step's by at least
  that state's bytes (the new copy the functional update makes) on one
  rank; on 8 its outputs are its inputs' local shards."""

import dataclasses
import json

import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import SHAPES
from repro_torch.launch import cells, dryrun
from repro_torch.launch.cells import build_cell, place_args, trace_cell
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.roofline.analysis import collective_bytes, extrapolate
from repro_torch.roofline.hbm import hbm_traffic
from repro_torch.sharding.rules import bytes_per_device
from repro_torch.train.steps import make_train_step
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)  # the test workers share the host's cores

# the reference's cells (tests/test_dryrun_cells.py), each cut to a few layers
CASES = [
    ("ds-paper-100m", "train_4k", dict(n_layers=2, d_model=64, n_heads=4, head_dim=16,
                                       n_kv_heads=2, d_ff=128, vocab_size=2048)),
    ("mixtral-8x7b", "decode_32k", dict(n_layers=2, d_model=64, n_heads=4, head_dim=16,
                                        n_kv_heads=2, moe_d_ff=128, n_experts=4,
                                        top_k=2, vocab_size=2048, sliding_window=256)),
    ("mamba2-1.3b", "long_500k", dict(n_layers=2, d_model=64, ssm_state=16,
                                      ssm_headdim=16, vocab_size=2048)),
]
# the train cell's 8 microbatches repeat one microbatch's ops: 2 run the
# accumulation at a quarter of the host time DTensor takes
TRAIN_MICROBATCHES = 2


@pytest.fixture
def mesh8():
    with dryrun.fake_world(8):
        yield make_test_mesh((2, 4), device="cpu")


def local_bytes(tree) -> int:
    return sum(getattr(t, "_local_tensor", t).numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch,shape,over", CASES, ids=[c[0] for c in CASES])
def test_reference_cells_trace_on_eight_ranks(mesh8, arch, shape, over):
    cfg = dataclasses.replace(get_arch(arch), **over)
    mb = TRAIN_MICROBATCHES if shape == "train_4k" else None
    cell = build_cell(arch, shape, mesh8, cfg_override=cfg, microbatches=mb)
    state = dryrun._analytic_arg_bytes(cell, mesh8)
    placed = place_args(cell, mesh8)
    assert state == sum(local_bytes(a) for a in placed)
    params = cell.args[0]
    assert local_bytes(placed[0]) == bytes_per_device(params, cell.in_shardings[0], mesh8)
    traced = trace_cell(cell, mesh8)
    tr = traced.recorder.trace
    hbm = hbm_traffic(tr)
    assert hbm.bytes_jnp > 0 and hbm.bytes_flash > 0 and tr.flops > 0
    assert tr.peak_temp_bytes > 0
    colls = collective_bytes(tr.collectives, 8)
    assert sum(colls.count_by_op.values()) > 0 and colls.total_bytes > 0
    if shape != "train_4k":  # a decode step updates its cache in place
        assert traced.alias_bytes == local_bytes(placed[1])
    else:  # a train step its parameters and optimizer state (donated)
        assert traced.alias_bytes == local_bytes(placed[:2])


# the train cell where the update, not the backward, holds the peak: wide
# enough that its state outweighs the activations of 2 rows of 512 tokens
WIDE_TRAIN = dict(n_layers=2, d_model=1024, n_heads=8, head_dim=128, n_kv_heads=4, d_ff=8192,
                  vocab_size=2048)


def test_donated_train_cell_drops_the_second_copy(monkeypatch):
    """On the card's layout (one rank), a train cell cut to 2 rows of 512
    tokens, wide enough that the update holds the peak, traced as built
    (donated) and with the functional step in its place."""
    monkeypatch.setitem(SHAPES, "train_4k",
                        dataclasses.replace(SHAPES["train_4k"], global_batch=2, seq_len=512))
    cfg = dataclasses.replace(get_arch("ds-paper-100m"), **WIDE_TRAIN)
    mesh, traced = {"data": 1, "model": 1}, {}
    for donate in (False, True):
        with monkeypatch.context() as m:
            if not donate:
                m.setattr(cells, "make_train_step",
                          lambda model, tcfg, donate: make_train_step(model, tcfg))
            cell = build_cell("ds-paper-100m", "train_4k", mesh, cfg_override=cfg,
                              microbatches=2)
        assert cell.donate == (0, 1)
        state = local_bytes(cell.args[:2])
        traced[donate] = trace_cell(cell, mesh)
    functional, donated = traced[False], traced[True]
    assert functional.alias_bytes == 0 and donated.alias_bytes == state
    drop = functional.recorder.trace.peak_temp_bytes - donated.recorder.trace.peak_temp_bytes
    assert drop >= state, (drop, state)


def test_probe_extrapolation_equals_direct_count(mesh8):
    cfg = reduced(get_arch("ds-paper-100m"), n_layers=8)
    arch, shape = "ds-paper-100m", "serve_paged_32k"
    policy = build_cell(arch, shape, mesh8, cfg_override=cfg).policy
    c2, c4, c8 = (dryrun.run_probe(arch, shape, n, policy, mesh=mesh8, cfg=cfg) for n in (2, 4, 8))
    flops, bytes_, bytes_jnp, coll = extrapolate(c2, c4, 2, 4, 8)
    assert flops == pytest.approx(c8.flops, rel=1e-12)
    assert bytes_ == pytest.approx(c8.bytes, rel=1e-12)
    assert bytes_jnp == pytest.approx(c8.bytes_jnp, rel=1e-12)
    assert coll.count_by_op == c8.collectives.count_by_op
    for op, b in c8.collectives.bytes_by_op.items():
        assert coll.bytes_by_op[op] == pytest.approx(b, rel=1e-12)
    assert c4.flops > c2.flops and c4.bytes > c2.bytes


def test_run_cell_on_one_rank_counts_the_card_layout():
    cfg = reduced(get_arch("ds-paper-100m"), n_layers=2)
    res = dryrun.run_cell("ds-paper-100m", "serve_paged_32k", mesh={"data": 1, "model": 1},
                          cfg_override=cfg, verbose=False)
    assert res["status"] == "ok" and res["mesh"] == "1x1" and res["collective_counts"] == {}
    mem = res["memory"]
    assert mem["fits"] and mem["alias_gib"] > 0 and mem["temp_gib"] > 0
    assert mem["projected_gib"] == pytest.approx(mem["state_gib_analytic"] + mem["temp_gib"])


DRYRUN_KEYS = {"arch", "shape", "mesh", "status", "policy", "microbatches", "lower_s",
               "compile_s", "memory", "entry_cost", "collective_counts"}
MEMORY_KEYS = {"argument_gib", "output_gib", "temp_gib", "alias_gib", "per_device_gib", "fits",
               "state_gib_analytic", "projected_gib", "fits_projected", "card_gib", "card"}
ROOFLINE_KEYS = {"status", "arch", "shape", "n_layers", "probe_layers", "flops_per_device",
                 "bytes_per_device", "bytes_per_device_jnp", "collective_bytes_per_device",
                 "collective_by_op", "collective_counts", "compute_s", "memory_s",
                 "collective_s", "dominant", "model_flops_global", "useful_ratio",
                 "roofline_fraction", "n_devices"}


def test_cli_writes_the_reference_keys_on_512_ranks(tmp_path):
    rc = dryrun.main(["--arch", "ds-paper-100m", "--shape", "serve_paged_32k", "--roofline",
                      "--out", str(tmp_path)])
    assert rc == 0
    for mesh in ("16x16", "2x16x16"):
        res = json.loads((tmp_path / "dryrun" / f"ds-paper-100m__serve_paged_32k__{mesh}.json")
                         .read_text())
        assert set(res) == DRYRUN_KEYS and set(res["memory"]) == MEMORY_KEYS
        assert res["status"] == "ok" and res["mesh"] == mesh
        assert res["memory"]["fits"] and sum(res["collective_counts"].values()) > 0
    roof = json.loads((tmp_path / "roofline" / "ds-paper-100m__serve_paged_32k.json").read_text())
    assert set(roof) == ROOFLINE_KEYS and roof["n_devices"] == 256
    assert roof["probe_layers"] == [2, 4] and roof["dominant"] in ("memory", "collective")
