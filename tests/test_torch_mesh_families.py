"""Every family of the port over a mesh: 4 CPU ranks (gloo, a (2, 2)
("data", "model") mesh, FSDP over "data" under ``train_rules``), each of
the nine reduced configs that ``test_torch_distribution.py`` does not
run (the MoE under ``capacity``, run whole on each rank; MLA; the
hybrid; the encoder-decoder over stub frames; the VLM over stub patches;
the windowed and the dense zoo), every parameter and the batch laid out
as DTensors: the sharded loss at 1e-4 of the reference's unsharded
``model.loss`` on the same weights (through the bridge).

The ranks (``torch_mesh_ranks.families_rank``) import torch and the port
alone."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro_torch.models.weights import params_from_jax
from torch_mesh_ranks import families_rank, join, start

torch.set_num_threads(1)  # the test workers share the host's cores

ARCHS = ("mixtral-8x7b", "deepseek-v2-236b", "zamba2-1.2b", "whisper-tiny", "internvl2-1b",
         "h2o-danube-3-4b", "granite-34b", "qwen2-72b", "nemotron-4-340b")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    cases, inputs = {}, {}
    for i, arch in enumerate(ARCHS):
        jm = JModel(jreduced(jget_arch(arch)), JRuntime())
        cfg = jm.cfg
        jp = jm.init(jax.random.PRNGKey(i))
        rng = np.random.default_rng(100 + i)
        toks = rng.integers(0, cfg.vocab_size, (4, 17))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_encoder_decoder:  # the encoder's stub frames
            batch["frames"] = rng.standard_normal((4, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)
        if cfg.n_vision_tokens:  # the VLM's stub patches
            batch["patches"] = rng.standard_normal((4, cfg.n_vision_tokens, cfg.d_model)).astype(
                np.float32)
        cases[arch] = (jm, jp, batch)
        inputs[arch] = {"params": params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
                        "batch": {k: torch.from_numpy(np.ascontiguousarray(v))
                                  for k, v in batch.items()}}
    torch.save(inputs, root / "inputs.pt")
    ranks = start(families_rank, 4, root)
    try:  # the reference's losses while the ranks run
        ref = {arch: float(jm.loss(jp, batch)[0]) for arch, (jm, jp, batch) in cases.items()}
    finally:
        join(ranks, root)
    return ref, torch.load(root / "out.pt")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_matches_reference(run, arch):
    ref, out = run
    assert abs(out[arch] - ref[arch]) < 1e-4, (out[arch], ref[arch])
