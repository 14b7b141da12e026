"""The port's payload "Somethings" (``distributed-train``,
``distributed-eval`` and the static ``distributed-serve``) run through
the port's ``DSRuntime``, against the reference's payloads through the
reference's, on reduced ``ds-paper-100m`` (plain path on the CPU, the
jobs say ``"device": "cpu"``).

Both packages start from the same weights: the reference's seed-0
parameters written as a checkpoint by the reference, since the two
packages' seed inits differ.  Held: the train spans' per-step losses
(rtol 1e-5) and final parameters (atol 1e-6), as ``test_torch_train.py``;
the final checkpoint's step; eval ``METRICS.json`` (rtol 1e-5); serve
completions token for token and every counter of ``RESULTS.json``,
paged and dense; and a serve job whose ``run`` is a checkpoint the
reference's training wrote."""

import shutil

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.launch.serve  # noqa: F401  (registers distributed-serve)
import repro.launch.train  # noqa: F401  (registers distributed-train/eval)
import repro_torch.core as tcore
import repro_torch.launch.serve  # noqa: F401
import repro_torch.launch.train  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.train import checkpoint as jckpt

torch.set_num_threads(1)  # the test workers share the host's cores

ARCH = {"arch": "ds-paper-100m", "arch_overrides": "reduced", "device": "cpu"}
TRAIN = {**ARCH, "seq_len": 16, "global_batch": 2, "lr": 1e-3, "warmup_steps": 2,
         "ckpt_every": 1}
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [42], [5, 4, 3, 2, 1, 17, 23, 31, 44],
           [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25, 26, 27, 28, 50]]
SERVE = {**ARCH, "max_new_tokens": 6, "max_len": 40, "max_batch": 2, "prefill_chunk": 4}


@pytest.fixture(scope="module")
def seed_weights(tmp_path_factory):
    """A store holding the reference's seed-0 parameters as run ``w`` at
    step 0, written by the reference."""
    root = tmp_path_factory.mktemp("weights")
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    jckpt.save_checkpoint(jcore.ObjectStore(str(root)), "w", 0, jm.init(jax.random.PRNGKey(0)))
    return root


def _store_with_weights(seed_weights, root, run="w"):
    shutil.copytree(seed_weights / "ckpt" / "w", root / "ckpt" / run)
    return root


def run_ds(core, root, payload, shared, groups, machines=1):
    clk = core.VirtualClock()
    cfg = core.DSConfig(app_name="Payloads", payload=payload, cluster_machines=machines,
                        tasks_per_machine=1, machine_type=["sim.large"], machine_price=1.0,
                        sqs_message_visibility=240.0, max_receive_count=8,
                        check_if_done=False)
    rt = core.DSRuntime(cfg, store_root=str(root), clock=clk)
    rt.setup()
    rt.submit_job(core.JobFile(shared=dict(shared), groups=[dict(g) for g in groups]))
    rt.start_cluster(core.FleetFile(startup_seconds=0.0))
    summary = core.SimRunner(rt, tick_seconds=30.0).run(max_ticks=400)
    assert summary.jobs_failed == 0 and summary.jobs_done == len(groups), summary
    return rt


def restore(root, run, step):
    jm = JModel(jreduced(jget_arch("ds-paper-100m")))
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jckpt.restore_checkpoint(jcore.ObjectStore(str(root)), run, step, like)


@pytest.fixture(scope="module")
def trained(seed_weights, tmp_path_factory):
    """Two spans of two steps of ``distributed-train`` from the reference's
    seed-0 weights, through each package's runtime."""
    roots = {}
    for name, core in (("ref", jcore), ("port", tcore)):
        root = _store_with_weights(seed_weights, tmp_path_factory.mktemp(name), run="t")
        jf = core.step_span_job_file(arch="ds-paper-100m", total_steps=4, span=2, run="t",
                                     shared=dict(TRAIN, total_steps=4))
        run_ds(core, root, "distributed-train", jf.shared, jf.groups)
        roots[name] = root
    return roots


def test_train_spans_match_reference(trained):
    ref, port = trained["ref"], trained["port"]
    for root in (ref, port):
        assert jckpt.latest_step(jcore.ObjectStore(str(root)), "t") == 4
    for step in range(1, 5):
        _, want = restore(ref, "t", step)
        _, got = restore(port, "t", step)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    want, _ = restore(ref, "t", 4)
    got, _ = restore(port, "t", 4)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-6)
    for span in ("000000-000002", "000002-000004"):
        a = jcore.ObjectStore(str(port)).get_json(f"runs/t/spans/{span}/DONE.json")
        b = jcore.ObjectStore(str(ref)).get_json(f"runs/t/spans/{span}/DONE.json")
        assert a["span"] == b["span"] and a["steps_run"] == b["steps_run"] == 2
        np.testing.assert_allclose(a["final_loss"], b["final_loss"], rtol=1e-5)


def test_eval_shards_match_reference(trained, tmp_path):
    # both evaluate the reference's trained checkpoint
    roots = {}
    for name, core in (("ref", jcore), ("port", tcore)):
        root = tmp_path / name
        shutil.copytree(trained["ref"] / "ckpt", root / "ckpt")
        run_ds(core, root, "distributed-eval", {**TRAIN, "run": "t", "n_batches": 2},
               [{"shard": 0}, {"shard": 1}])
        roots[name] = jcore.ObjectStore(str(root))
    for shard in (0, 1):
        key = f"runs/t/eval/shard{shard}/METRICS.json"
        got, want = roots["port"].get_json(key), roots["ref"].get_json(key)
        assert {k: got[k] for k in ("run", "shard", "ckpt_step")} == \
            {k: want[k] for k in ("run", "shard", "ckpt_step")} == \
            {"run": "t", "shard": shard, "ckpt_step": 4}
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)


SERVE_CASES = {
    "paged": dict(cache_mode="paged", page_size=8, total_pages=12),
    "paged_adaptive_pool": dict(cache_mode="paged", page_size=8),
    "dense": dict(cache_mode="dense"),
    "temperature_stop": dict(cache_mode="paged", page_size=8, temperature=0.7, stop_token=7),
}


def _serve_both(tmp_path, weights_root, job):
    results = {}
    for name, core in (("ref", jcore), ("port", tcore)):
        root = tmp_path / name
        shutil.copytree(weights_root / "ckpt", root / "ckpt")
        run_ds(core, root, "distributed-serve", job,
               [{"prompts": PROMPTS[:3], "output_prefix": "serve/b0"},
                {"prompts": PROMPTS[3:], "output_prefix": "serve/b1"}])
        store = jcore.ObjectStore(str(root))
        results[name] = {b: store.get_json(f"serve/{b}/RESULTS.json") for b in ("b0", "b1")}
    return results


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_static_serve_matches_reference(seed_weights, tmp_path, case):
    results = _serve_both(tmp_path, seed_weights, {**SERVE, "run": "w", **SERVE_CASES[case]})
    assert results["port"] == results["ref"]
    assert sum(len(r["requests"]) for r in results["ref"].values()) == len(PROMPTS)


def test_serve_from_a_checkpoint_the_reference_trained(trained, tmp_path):
    results = _serve_both(tmp_path, trained["ref"],
                          {**SERVE, "run": "t", "cache_mode": "paged", "page_size": 8})
    assert results["port"] == results["ref"]
