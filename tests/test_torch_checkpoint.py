"""Checkpoints and the job runners across the two packages (plain path
on the CPU), through one object-store directory:

- the reference's ``distributed-train`` payload writes span [0, 2); the
  port's span runner resumes it for [2, 4); the result agrees with the
  reference's own [2, 4) (losses rtol 1e-5, parameters atol 1e-6: f32 on
  both sides, summation order only);
- port checkpoints of parameters (f32 and bf16) and of optimizer states
  (f32 and int8 moments) restore in ``repro.train.checkpoint`` bit for
  bit, and a reference bf16 checkpoint restores in the port;
- a span whose prerequisite checkpoint is missing raises ``NotReady``;
- the eval runner's loss and perplexity equal the reference's
  ``distributed-eval`` on the same checkpoint (rtol 1e-5)."""

import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.storage import ObjectStore as JStore
from repro.launch import train as jtrain
from repro.models import Model as JModel
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch, reduced
from repro_torch.core.storage import ObjectStore
from repro_torch.launch import train as ttrain
from repro_torch.models import Model, ModelRuntime
from repro_torch.models.weights import params_from_jax, params_to_jax, to_reference_layout
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)  # the test workers share the host's cores

JOB = {"arch": "ds-paper-100m", "arch_overrides": "reduced", "run": "r", "seq_len": 16,
       "global_batch": 2}


def beat(progress=None):
    pass


def jctx(root):
    return types.SimpleNamespace(store=JStore(str(root)), heartbeat=beat)


def restore_reference(root, run, step, dtype=jnp.float32):
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    like = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, dtype), like)
    return jckpt.restore_checkpoint(JStore(str(root)), run, step, like)[0]


def test_port_resumes_a_reference_span(tmp_path):
    root, theirs = tmp_path / "store", tmp_path / "theirs"
    jtrain.train_payload({**JOB, "start_step": 0, "num_steps": 2}, jctx(root))
    shutil.copytree(root, theirs)
    got = ttrain.run_train_span({**JOB, "start_step": 2, "num_steps": 2}, ObjectStore(str(root)),
                                beat, device="cpu")
    want = jtrain.train_payload({**JOB, "start_step": 2, "num_steps": 2}, jctx(theirs))
    assert got["span"] == want["span"] == [2, 4] and got["steps_run"] == 2
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-5)
    assert JStore(str(root)).get_json("runs/r/spans/000002-000004/DONE.json")["steps_run"] == 2
    a = jax.tree.leaves(restore_reference(root, "r", 4))
    b = jax.tree.leaves(restore_reference(theirs, "r", 4))
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-6)
    # the port's own optimizer state at step 4 restores in the reference
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    opt_like = jax.eval_shape(lambda p: jopt.init_opt_state(p, jopt.AdamWConfig()),
                              jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    mine, _ = jckpt.restore_checkpoint(JStore(str(root)), "r-opt", 4, opt_like)
    ref, _ = jckpt.restore_checkpoint(JStore(str(theirs)), "r-opt", 4, opt_like)
    assert int(mine["step"]) == 4
    for x, y in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_checkpoint_restores_in_reference(tmp_path, dtype):
    m = Model(reduced(get_arch("ds-paper-100m")), ModelRuntime(dtype=dtype))
    params = m.init(3, device="cpu")
    tckpt.save_state(ObjectStore(str(tmp_path)), "p", 7, params, extra_meta={"loss": 1.5})
    manifest = JStore(str(tmp_path)).get_json("ckpt/p/7/manifest.json")
    assert manifest["meta"] == {"loss": 1.5}
    names = {entry["key"]: entry["dtype"] for entry in manifest["leaves"]}
    assert names["layers.attn.wq"] == ("bfloat16" if dtype == torch.bfloat16 else "float32")
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    restored = restore_reference(tmp_path, "p", 7, jdtype)
    want = params_to_jax(params)  # bf16 widens exactly to float32
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(restored), jax.tree.leaves(want)):
        assert x.dtype == jdtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(x, np.float32), y)
    # and back into the port, bit for bit
    back, meta = tckpt.restore_state(ObjectStore(str(tmp_path)), "p", 7, m.abstract_params(),
                                     device="cpu")
    assert meta == {"loss": 1.5}
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert x.dtype == dtype and torch.equal(x, y)


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_port_optimizer_state_restores_in_reference(tmp_path, moments):
    cfg = topt.AdamWConfig(moments_dtype=moments)
    m = Model(reduced(get_arch("ds-paper-100m")))
    params = m.init(1, device="cpu")
    grads = jax.tree.map(lambda p: torch.randn_like(p) * 1e-2, params)
    _, state, _ = topt.adamw_update(params, grads, topt.init_opt_state(params, cfg), cfg)
    tckpt.save_state(ObjectStore(str(tmp_path)), "p-opt", 1, state)
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jcfg = jopt.AdamWConfig(moments_dtype=moments)
    like = jax.eval_shape(lambda p: jopt.init_opt_state(p, jcfg),
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    restored, _ = jckpt.restore_checkpoint(JStore(str(tmp_path)), "p-opt", 1, like)
    assert int(restored["step"]) == 1
    mine = to_reference_layout({k: v for k, v in state.items() if k != "step"})
    for x, y in zip(jax.tree.leaves({k: v for k, v in restored.items() if k != "step"}),
                    jax.tree.leaves(mine)):
        assert np.asarray(x).dtype == y.numpy().dtype
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_reference_bf16_checkpoint_restores_in_port(tmp_path):
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jm.init(jax.random.PRNGKey(2)))
    jckpt.save_checkpoint(JStore(str(tmp_path)), "b", 3, jp)
    m = Model(reduced(get_arch("ds-paper-100m")), ModelRuntime(dtype=torch.bfloat16))
    got, _ = tckpt.restore_state(ObjectStore(str(tmp_path)), "b", 3, m.abstract_params(),
                                 device="cpu")
    want = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), device="cpu",
                           dtype=torch.bfloat16)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
    assert tckpt.latest_step(ObjectStore(str(tmp_path)), "b") == 3
    assert tckpt.checkpoint_exists(ObjectStore(str(tmp_path)), "b", 3)
    assert not tckpt.checkpoint_exists(ObjectStore(str(tmp_path)), "b", 4)


def test_span_waits_for_its_prerequisite(tmp_path):
    with pytest.raises(ttrain.NotReady, match="prerequisite") as err:
        ttrain.run_train_span({**JOB, "start_step": 2, "num_steps": 2, "prereq_retry_s": 3.0},
                              ObjectStore(str(tmp_path)), beat, device="cpu")
    assert err.value.retry_in == 3.0


def test_eval_matches_reference(tmp_path):
    jtrain.train_payload({**JOB, "start_step": 0, "num_steps": 1}, jctx(tmp_path))
    job = {**JOB, "n_batches": 2, "shard": 1}
    want = jtrain.eval_payload(job, jctx(tmp_path))
    got = ttrain.run_eval(job, ObjectStore(str(tmp_path)), beat, device="cpu")
    assert got["ckpt_step"] == want["ckpt_step"] == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)
    assert JStore(str(tmp_path)).get_json("runs/r/eval/shard1/METRICS.json")["shard"] == 1
