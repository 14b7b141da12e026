"""The three user-facing drivers of both packages run on the CPU at small
arguments and give the same results: ``examples/`` over the reference
and ``examples_torch/`` over the port (with ``--device cpu``), each run
in this process as ``python <script>`` would run it.

Both start from the same weights: the port's ``Model.init`` is patched
to the reference's seed init (carried over by ``params_from_jax``),
since the two packages' seed inits differ.  Each script's scratch
directory (``tempfile.mkdtemp``) is one of the test's, and each run's
``SimRunner``/``ThreadRunner`` summary is kept.  Held:

- ``quickstart.py --steps 4 --span 2``: the final checkpoint's step and
  each span's final loss (rtol 1e-5);
- ``sweep_with_preemption.py``: the losses per learning rate (rtol 1e-5)
  and the fleet's counts under the same market seed (jobs done, failed
  and so redelivered, dead letters, preemptions, ticks);
- ``serve_batch.py``: every request's completion, token for token."""

import dataclasses
import itertools
import runpy
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import Model as JModel
from repro_torch.models import Model
from repro_torch.models.weights import params_from_jax

torch.set_num_threads(1)  # the test workers share the host's cores

ROOT = Path(__file__).resolve().parents[1]
QUICKSTART = ["--steps", "4", "--span", "2", "--workers", "1", "--seq-len", "32", "--batch", "2"]


def reference_init(self, seed: int, device=None):
    """The reference's seed-``seed`` parameters, in the port's layout."""
    jcfg = JArchConfig(**dataclasses.asdict(self.cfg))
    params = JModel(jcfg).init(jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree.map(np.asarray, params), device=device, dtype=self.rt.dtype)


def run_example(monkeypatch, tmp_path, package: str, script: str, args: list) -> dict:
    """``python <package>/<script> <args>`` in this process: its scratch
    directories under ``tmp_path`` and its runners' summaries."""
    import repro_torch.launch.serve as tserve

    dirs = (tmp_path / f"{package}-{i}" for i in itertools.count())

    def mkdtemp(prefix="tmp", **_):
        d = next(dirs)
        d.mkdir()
        return str(d)

    summaries = []
    core = jcore if package == "examples" else tcore
    for runner in (core.SimRunner, core.ThreadRunner):
        run = runner.run

        def keep(self, *a, _run=run, **kw):
            summaries.append(_run(self, *a, **kw))
            return summaries[-1]

        monkeypatch.setattr(runner, "run", keep)
    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(Model, "init", reference_init)
    tserve._MODEL_CACHE.clear()
    tserve._PARAM_CACHE.clear()
    if package == "examples_torch":
        args = args + ["--device", "cpu"]
    monkeypatch.setattr(sys, "argv", [script] + args)
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(ROOT / package / script), run_name="__main__")
    assert done.value.code == 0
    monkeypatch.undo()
    return {"store": jcore.ObjectStore(str(tmp_path / f"{package}-0" / "store")),
            "summaries": summaries}


def both(monkeypatch, tmp_path, script: str, args: list = ()) -> tuple:
    return tuple(run_example(monkeypatch, tmp_path, pkg, script, list(args))
                 for pkg in ("examples", "examples_torch"))


def test_quickstart(monkeypatch, tmp_path):
    ref, port = both(monkeypatch, tmp_path, "quickstart.py", QUICKSTART)
    from repro.train.checkpoint import latest_step

    assert latest_step(ref["store"], "quickstart") == latest_step(port["store"],
                                                                  "quickstart") == 4
    for span in ("000000-000002", "000002-000004"):
        key = f"runs/quickstart/spans/{span}/DONE.json"
        a, b = port["store"].get_json(key), ref["store"].get_json(key)
        assert a["span"] == b["span"] and a["steps_run"] == b["steps_run"] == 2
        np.testing.assert_allclose(a["final_loss"], b["final_loss"], rtol=1e-5)
    assert port["summaries"][0].jobs_done == ref["summaries"][0].jobs_done == 2


def test_sweep_with_preemption(monkeypatch, tmp_path):
    ref, port = both(monkeypatch, tmp_path, "sweep_with_preemption.py")
    for lr in (1e-4, 3e-4, 1e-3, 3e-3):
        key = f"sweep/lr{lr:g}/DONE.json"
        a, b = port["store"].get_json(key), ref["store"].get_json(key)
        assert a["steps_run"] == b["steps_run"] == 8
        np.testing.assert_allclose(a["final_loss"], b["final_loss"], rtol=1e-5)
    (a,), (b,) = port["summaries"], ref["summaries"]
    for field in ("jobs_done", "jobs_skipped", "jobs_failed", "dead_letters", "preemptions",
                  "idle_terminations", "ticks"):
        assert getattr(a, field) == getattr(b, field), field
    assert a.jobs_done == 4


def test_serve_batch(monkeypatch, tmp_path):
    ref, port = both(monkeypatch, tmp_path, "serve_batch.py")
    for i in range(3):
        a = port["store"].get_json(f"serve/batch{i}/RESULTS.json")
        b = ref["store"].get_json(f"serve/batch{i}/RESULTS.json")
        assert a["requests"].keys() == b["requests"].keys()
        for uid, r in b["requests"].items():
            assert a["requests"][uid]["prompt"] == r["prompt"]
            assert a["requests"][uid]["completion"] == r["completion"], uid
