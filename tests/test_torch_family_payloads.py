"""The port's ``distributed-train`` payload for the families past
``ds-paper-100m`` (reduced ``mamba2-1.3b``, ``zamba2-1.2b``,
``deepseek-v2-236b`` under ``capacity`` and ``h2o-danube-3-4b`` on rows
longer than its reduced window of 32), through the port's ``DSRuntime``
against the reference's payload through the reference's (plain path on
the CPU, the jobs say ``"device": "cpu"``).

Both start from the reference's seed-0 parameters, written as a
checkpoint by the reference (zamba2's ``lora_b`` drawn non-zero: its init
is zeros), since the two packages' seed inits differ.  Two spans of two
steps each; held: every step's loss (rtol 1e-5), each span's
``DONE.json`` and every leaf of the final tree at atol 1e-6, as
``test_torch_ds_payloads.py`` holds ``ds-paper-100m``'s, save a few
elements AdamW leaves at the mercy of rounding.  AdamW divides each
element's first moment by the root of its second, so an element whose
gradient is rounding noise moves by a sizeable share of the learning
rate in either package, differently: zamba2's worst, a mixer
``out_proj`` entry, has a first gradient of -1.30e-7 in the port and
-3.36e-7 in the reference, against the leaf's largest 1.11, whose
gradients agree to 2.7e-6, and ends 7.1e-5 apart.  So at most
``NOISE_SHARE`` of the tree's elements may pass 1e-6 (zamba2 has 103 of
485,664 there, 2.1e-4; mamba2 1, deepseek 6, danube 2), and none may
pass ``2 * sum(lr)`` over the steps, the most that AdamW updates of
opposite sign could put between them.  A fault in the payload (the moments lost
at a span's resume, a schedule off by a step) moves most elements by a
share of the learning rate, far past both."""

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.launch.train  # noqa: F401  (registers distributed-train)
import repro_torch.core as tcore
import repro_torch.launch.train  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.train import checkpoint as jckpt
from repro_torch.train.optimizer import Schedule
from test_torch_ds_payloads import run_ds
from test_torch_grads import with_lora_b

torch.set_num_threads(1)  # the test workers share the host's cores

TRAIN = {"arch_overrides": "reduced", "device": "cpu", "global_batch": 2, "lr": 1e-3,
         "warmup_steps": 2, "ckpt_every": 1}
NOISE_SHARE = 1e-3  # of the tree's elements may pass atol 1e-6 (the docstring says why)
FAMILIES = {  # arch -> the job's own keys
    "mamba2-1.3b": {"seq_len": 16},
    "zamba2-1.2b": {"seq_len": 16},
    "deepseek-v2-236b": {"seq_len": 16, "moe_strategy": "capacity"},
    "h2o-danube-3-4b": {"seq_len": 48},  # past the reduced window of 32
}


def seed_store(root, arch: str):
    """A store holding the reference's seed-0 parameters as run ``t`` at
    step 0, written by the reference."""
    params = JModel(jreduced(jget_arch(arch))).init(jax.random.PRNGKey(0))
    if "lora_b" in params.get("shared", {}):
        params = with_lora_b(params)
    jckpt.save_checkpoint(jcore.ObjectStore(str(root)), "t", 0, params)
    return root


def restore(root, arch: str, step: int):
    like = jax.eval_shape(JModel(jreduced(jget_arch(arch))).init, jax.random.PRNGKey(0))
    return jckpt.restore_checkpoint(jcore.ObjectStore(str(root)), "t", step, like)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_spans_match_reference(arch, tmp_path):
    shared = {**TRAIN, **FAMILIES[arch], "total_steps": 4}
    roots = {}
    for name, core in (("ref", jcore), ("port", tcore)):
        root = seed_store(tmp_path / name, arch)
        jf = core.step_span_job_file(arch=arch, total_steps=4, span=2, run="t", shared=shared)
        run_ds(core, root, "distributed-train", jf.shared, jf.groups)
        roots[name] = root
    ref, port = roots["ref"], roots["port"]
    for root in (ref, port):
        assert jckpt.latest_step(jcore.ObjectStore(str(root)), "t") == 4
    for step in range(1, 5):
        want, got = restore(ref, arch, step)[1], restore(port, arch, step)[1]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    want, got = restore(ref, arch, 4)[0], restore(port, arch, 4)[0]
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    lr = Schedule(peak_lr=TRAIN["lr"], warmup_steps=TRAIN["warmup_steps"], total_steps=4)
    flip = 2 * sum(lr(s) for s in range(5))
    off = size = 0
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        d = np.abs(np.asarray(a) - np.asarray(b))
        assert d.max() <= flip, (jax.tree_util.keystr(path), float(d.max()), flip)
        off, size = off + int((d > 1e-6).sum()), size + d.size
    assert off <= NOISE_SHARE * size, (off, size)
    for span in ("000000-000002", "000002-000004"):
        a = jcore.ObjectStore(str(port)).get_json(f"runs/t/spans/{span}/DONE.json")
        b = jcore.ObjectStore(str(ref)).get_json(f"runs/t/spans/{span}/DONE.json")
        assert a["span"] == b["span"] and a["steps_run"] == b["steps_run"] == 2
        np.testing.assert_allclose(a["final_loss"], b["final_loss"], rtol=1e-5)
