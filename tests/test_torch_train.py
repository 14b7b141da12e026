"""The port's full-sequence path and training (plain path on the CPU)
against the reference package on shared weights and identical data:

- ``SyntheticLM`` batches, token for token;
- a ``train_step`` against the reference's ``make_train_step`` for one
  batch and for 2 microbatches accumulated in f32, bf16 and int8, over 2
  steps: loss and gradient norm, updated parameters and moments;
- the optimizer's int8 moment quantizer, the schedule and the int8
  stochastic rounding of a gradient tree, exactly or to float32 rounding.

Tolerances: f32 on both sides differs by summation order only (loss
rtol 1e-5; parameters atol 1e-6; moments atol 1e-8).  Accumulating in
bf16 or int8 rounds each gradient element once; where the two packages'
f32 gradients straddle a rounding boundary the element moves by one bf16
ulp or one int8 level, which moves the gradient norm by < 1e-4 relative,
a moment by < 1e-4 and a parameter by < 1e-5 over these 2 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ModelRuntime as JRuntime
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.data import TokenFileDataset as JTokenFile
from repro.train.steps import TrainStepConfig as JStepConfig
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import prng
from repro_torch.configs import get_arch, reduced
from repro_torch.models import Model
from repro_torch.models.weights import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train.data import DataConfig, SyntheticLM, TokenFileDataset, \
    write_synthetic_corpus
from repro_torch.train.steps import TrainStepConfig, make_train_step

torch.set_num_threads(1)  # the test workers share the host's cores

SCHED = dict(peak_lr=3e-4, warmup_steps=20, total_steps=1000)  # the job defaults


@pytest.fixture(scope="module")
def shared():
    """(jax model, jax params, port config, port params) on one weight set."""
    jm = JModel(jreduced(jget_arch("ds-paper-100m")), JRuntime(attn_impl="direct"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced(get_arch("ds-paper-100m"))
    return jm, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("dp_rank,n_dp", [(0, 1), (1, 2)])
def test_synthetic_batches_equal_reference(dp_rank, n_dp):
    for arch in (jreduced(jget_arch("ds-paper-100m")), jget_arch("ds-paper-100m")):
        want = JSyntheticLM(arch, JDataConfig(seq_len=40, global_batch=4, seed=3))
        got = SyntheticLM(arch, DataConfig(seq_len=40, global_batch=4, seed=3), device="cpu")
        for step in (0, 1, 17):
            a = want.batch(step, dp_rank=dp_rank, n_dp=n_dp)
            b = got.batch(step, dp_rank=dp_rank, n_dp=n_dp)
            for k in ("tokens", "labels"):
                assert b[k].dtype == torch.int64
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


def test_token_file_batches_equal_reference(tmp_path):
    path = write_synthetic_corpus(str(tmp_path / "corpus.bin"), 4000, 256, seed=2)
    cfg = reduced(get_arch("ds-paper-100m"))
    want = JTokenFile(path, cfg, JDataConfig(seq_len=31, global_batch=4))
    got = TokenFileDataset(path, cfg, DataConfig(seq_len=31, global_batch=4), device="cpu")
    assert got.n_batches() == want.n_batches()
    for step in range(3):
        a, b = want.batch(step, dp_rank=1, n_dp=2), got.batch(step, dp_rank=1, n_dp=2)
        np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(a["tokens"]))


# ------------------------------------------------------------ train step
STEP_CASES = [(1, "f32"), (2, "f32"), (2, "bf16"), (2, "int8")]


@pytest.mark.parametrize("microbatches,accum", STEP_CASES)
def test_train_step_matches_reference(shared, microbatches, accum):
    jm, jp, cfg, p = shared
    jcfg = JStepConfig(microbatches=microbatches, accum_dtype=accum,
                       opt=jopt.AdamWConfig(schedule=jopt.Schedule(**SCHED)))
    tcfg = TrainStepConfig(microbatches=microbatches, accum_dtype=accum,
                           opt=topt.AdamWConfig(schedule=topt.Schedule(**SCHED)))
    jstep, tstep = jax.jit(jmake_train_step(jm, jcfg)), make_train_step(Model(cfg), tcfg)
    jdata = JSyntheticLM(jm.cfg, JDataConfig(seq_len=32, global_batch=4))
    tdata = SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=4), device="cpu")
    jps, jos = jp, jopt.init_opt_state(jp, jcfg.opt)
    tps, tos = p, topt.init_opt_state(p, tcfg.opt)
    exact = accum == "f32"
    for step in range(2):
        jps, jos, jmet = jstep(jps, jos, jdata.batch(step), jax.random.PRNGKey(step))
        tps, tos, tmet = tstep(tps, tos, tdata.batch(step), prng.PRNGKey(step, device="cpu"))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-5 if exact else 1e-4)
        np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    for a, b in zip(leaves(params_to_jax(tps)), leaves(jps)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 if exact else 1e-5)
    got_opt, want_opt = opt_state_to_jax(tos), jax.tree.map(np.asarray, jos)
    assert int(got_opt["step"]) == int(want_opt["step"]) == 2
    for a, b in zip(leaves(got_opt), leaves(want_opt)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 if exact else 1e-4)


# ------------------------------------------------------------ optimizer pieces
@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_optimizer_state_bridge_round_trips(shared, moments):
    """The reference's optimizer state after a step crosses into the port
    (layers unstacked, int8 moments kept int8) and back unchanged, and a
    step from it equals the reference's next step."""
    jm, jp, cfg, p = shared
    jcfg = JStepConfig(opt=jopt.AdamWConfig(schedule=jopt.Schedule(**SCHED),
                                            moments_dtype=moments))
    jstep = jax.jit(jmake_train_step(jm, jcfg))
    jdata = JSyntheticLM(jm.cfg, JDataConfig(seq_len=32, global_batch=4))
    jp1, jos, _ = jstep(jp, jopt.init_opt_state(jp, jcfg.opt), jdata.batch(0),
                        jax.random.PRNGKey(0))
    np_state = jax.tree.map(np.asarray, jos)
    state = opt_state_from_jax(np_state, device="cpu")
    assert state["step"] == 1 and len(state["mu"]["layers"]) == cfg.n_layers
    for a, b in zip(jax.tree.leaves(opt_state_to_jax(state)), jax.tree.leaves(np_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tcfg = TrainStepConfig(opt=topt.AdamWConfig(schedule=topt.Schedule(**SCHED),
                                                moments_dtype=moments))
    tdata = SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=4), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jp1), device="cpu")
    _, _, tmet = make_train_step(Model(cfg), tcfg)(params, state, tdata.batch(1),
                                                   prng.PRNGKey(1, device="cpu"))
    _, _, jmet = jstep(jp1, jos, jdata.batch(1), jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)



@pytest.mark.parametrize("shape", [(300,), (4, 200), (2, 3, 128), ()])
def test_int8_moment_quantizer_matches_reference(shape):
    x = np.asarray(np.random.default_rng(1).standard_normal(shape) * 3e-3, np.float32)
    want = jopt.quantize_blockwise(jnp.asarray(x))
    got = topt.quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        topt.dequantize_blockwise(got, shape).numpy(),
        np.asarray(jopt.dequantize_blockwise(want, shape)))


def test_adamw_with_fp32_master_matches_reference(shared):
    """bf16 parameters with an fp32 master copy: the update runs on the
    master and casts back, as the reference's ``master_fp32``."""
    _, jp, _, p = shared
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda a: np.asarray(rng.standard_normal(a.shape), np.float32) * 0.1,
                         jax.tree.map(np.asarray, jp))
    jcfg = jopt.AdamWConfig(schedule=jopt.Schedule(**SCHED), master_fp32=True)
    tcfg = topt.AdamWConfig(schedule=topt.Schedule(**SCHED), master_fp32=True)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tparams = jax.tree.map(lambda t: t.to(torch.bfloat16), p)
    jnew, jstate, _ = jopt.adamw_update(jparams, jax.tree.map(jnp.asarray, grads),
                                        jopt.init_opt_state(jparams, jcfg), jcfg)
    tnew, tstate, _ = topt.adamw_update(tparams, params_from_jax(grads, device="cpu"),
                                        topt.init_opt_state(tparams, tcfg), tcfg)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(tnew))
    for a, b in zip(leaves(params_to_jax(tnew)), leaves(jnew)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)  # one bf16 ulp at |w| < 2
    for a, b in zip(leaves(opt_state_to_jax(tstate)["master"]), leaves(jstate["master"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def test_schedule_matches_reference():
    sj, st = jopt.Schedule(**SCHED), topt.Schedule(**SCHED)
    for step in (0, 1, 7, 19, 20, 21, 500, 999, 1000, 1500):
        np.testing.assert_allclose(st(step), float(sj(jnp.asarray(step))), rtol=1e-6)


def test_int8_moments_train_step_runs(shared):
    """8-bit moments: the state keeps the parameter layout (int8 ``q`` and
    a float32 scale per 128-block) and the loss is the reference's."""
    jm, jp, cfg, p = shared
    opt = topt.AdamWConfig(schedule=topt.Schedule(**SCHED), moments_dtype="int8")
    step = make_train_step(Model(cfg), TrainStepConfig(opt=opt))
    batch = SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=4), device="cpu").batch(0)
    _, state, met = step(p, topt.init_opt_state(p, opt), batch, prng.PRNGKey(0, device="cpu"))
    wq = state["mu"]["layers"][0]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["q"].shape == p["layers"][0]["attn"]["wq"].shape
    assert wq["scale"].shape == (64, 1)
    jcfg = jopt.AdamWConfig(schedule=jopt.Schedule(**SCHED), moments_dtype="int8")
    _, _, jmet = jax.jit(jmake_train_step(jm, JStepConfig(opt=jcfg)))(
        jp, jopt.init_opt_state(jp, jcfg),
        JSyntheticLM(jm.cfg, JDataConfig(seq_len=32, global_batch=4)).batch(0),
        jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)


def test_stochastic_rounding_matches_reference():
    """On the same gradient tree and key, every element rounds as the
    reference's (eager) ``compress_tree`` rounds it: the per-leaf keys come
    from one split in JAX's leaf order and the draws are the same."""
    rng = np.random.default_rng(4)
    shapes = {"w": (3, 300), "layers": {"b": (2, 4, 256), "a": (5,)}, "s": ()}
    grads = jax.tree.map(lambda shape: np.asarray(rng.standard_normal(shape), np.float32),
                         shapes, is_leaf=lambda x: isinstance(x, tuple))
    want = jcomp.compress_tree(jax.tree.map(jnp.asarray, grads), jax.random.PRNGKey(7))
    got = tcomp.compress_tree(jax.tree.map(torch.from_numpy, grads), prng.PRNGKey(7, device="cpu"))
    flat_want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    flat_got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    assert len(flat_got) == len(flat_want) == 8
    for a, b in zip(flat_want, flat_got):
        np.testing.assert_array_equal(b, a)
    back = tcomp.decompress_tree(got, jax.tree.map(torch.from_numpy, grads))
    want_back = jcomp.decompress_tree(want, grads)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, want_back)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), back))):
        np.testing.assert_array_equal(b, a)
