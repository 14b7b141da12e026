"""The paper's four commands for the port, ``python -m
repro_torch.launch.run_ds setup | submitJob | startCluster | monitor``,
driven through ``run_ds.main`` in a temporary workdir with
``startCluster --foreground`` (the worker host's ``ThreadRunner`` runs
in-process).  A static ``distributed-serve`` job that says ``"device":
"cpu"`` is served and equals the port's engine run directly on the same
seed-0 weights; a ``distributed-train`` span runs too.  A job without
``device`` runs on ``cuda``: on a host without a card it fails with
``resolve_device``'s message in the exported logs, is never served on the
CPU, and marches to the dead-letter queue."""

import json
import os
import time
from pathlib import Path

import torch

from repro_torch.core.storage import ObjectStore
from repro_torch.launch import run_ds
from repro_torch.launch.train import build_model
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(1)  # the test workers share the host's cores

SERVE = {"arch": "ds-paper-100m", "arch_overrides": "reduced", "max_new_tokens": 5,
         "max_len": 32, "max_batch": 2, "prefill_chunk": 4, "cache_mode": "paged",
         "page_size": 8}
PROMPTS = [[1, 2, 3, 4, 5], [9, 8], [42, 43, 44]]


def _write(path, obj):
    path.write_text(json.dumps(obj))
    return str(path)


def _four_commands(tmp_path, app, job, *, max_receive_count=3):
    tmp_path.mkdir(parents=True, exist_ok=True)
    wd = tmp_path / "wd"
    config = _write(tmp_path / "config.json", {
        "app_name": app, "payload": job.pop("payload"), "cluster_machines": 1,
        "tasks_per_machine": 1, "machine_type": ["sim.large"], "machine_price": 1.0,
        "sqs_message_visibility": 1.0, "max_receive_count": max_receive_count,
        "check_if_done": False})
    jobfile = _write(tmp_path / "job.json", job)
    fleet = _write(tmp_path / "fleet.json", {"startup_seconds": 0.0})
    assert run_ds.main(["--workdir", str(wd), "setup", "--config", config]) == 0
    assert run_ds.main(["--workdir", str(wd), "submitJob", jobfile]) == 0
    assert run_ds.main(["--workdir", str(wd), "startCluster", fleet, "--foreground"]) == 0
    assert run_ds.main(["--workdir", str(wd), "monitor", "--poll", "0.05"]) == 0
    store = ObjectStore(str(wd / "store"))
    return store, store.get_json(f"summary/{app}.json")


def test_four_commands_serve_and_train_on_the_cpu(tmp_path):
    job = {"payload": "distributed-serve", **SERVE, "device": "cpu",
           "groups": [{"prompts": PROMPTS, "output_prefix": "serve/b0"}]}
    store, summary = _four_commands(tmp_path / "serve", "PortServe", job)
    assert summary["jobs_done"] == 1 and summary["jobs_failed"] == 0
    res = store.get_json("serve/b0/RESULTS.json")
    model = build_model(SERVE)
    eng = ServeEngine(model, model.init(0, device="cpu"), device="cpu", max_batch=2,
                      max_len=32, prefill_chunk=4, cache_mode="paged", page_size=8)
    eng.submit([Request(uid=f"req{i}", prompt=p, max_new_tokens=5)
                for i, p in enumerate(PROMPTS)])
    want = {r.uid: r.output for r in eng.run_to_completion()}
    assert {u: r["completion"] for u, r in res["requests"].items()} == want
    assert res["dispatches"] == eng.dispatches and res["tokens_emitted"] == 15
    assert store.exists("PortServeSpotFleetRequestId.json")

    job = {"payload": "distributed-train", "arch": "ds-paper-100m",
           "arch_overrides": "reduced", "device": "cpu", "seq_len": 16, "global_batch": 2,
           "run": "r", "groups": [{"start_step": 0, "num_steps": 2}]}
    store, summary = _four_commands(tmp_path / "train", "PortTrain", job)
    assert summary["jobs_done"] == 1
    assert store.get_json("runs/r/spans/000000-000002/DONE.json")["steps_run"] == 2


def test_job_without_device_fails_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = {"payload": "distributed-serve", **SERVE,
           "groups": [{"prompts": PROMPTS, "output_prefix": "serve/b0"}]}
    store, summary = _four_commands(tmp_path, "PortNoCard", job, max_receive_count=1)
    assert summary["jobs_done"] == 0 and summary["jobs_failed"] >= 1
    assert not store.exists("serve/b0/RESULTS.json")
    logs = "".join(store.get_text(i.key) for i in store.list("logs/PortNoCard/"))
    assert "runs on a CUDA device by default and none is available" in logs
    assert "device='cpu'" in logs
    # its one allowed receive is spent: the next receive dead-letters it
    assert "job failed (attempt 1/1)" in logs


def test_detached_worker_host_serves_on_the_cpu(tmp_path, monkeypatch):
    """``startCluster`` without ``--foreground`` spawns ``python -m
    repro_torch.launch.worker_host`` detached; ``monitor`` polls the
    queue until it drains, and the host writes its summary at teardown."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [src, *filter(None, [os.environ.get("PYTHONPATH")])]))
    wd = tmp_path / "wd"
    config = _write(tmp_path / "config.json", {
        "app_name": "PortDetached", "payload": "distributed-serve", "cluster_machines": 1,
        "machine_type": ["sim.large"], "machine_price": 1.0, "check_if_done": False})
    job = _write(tmp_path / "job.json", {**SERVE, "device": "cpu", "groups": [
        {"prompts": PROMPTS, "output_prefix": "serve/b0"}]})
    fleet = _write(tmp_path / "fleet.json", {"startup_seconds": 0.0})
    assert run_ds.main(["--workdir", str(wd), "setup", "--config", config]) == 0
    assert run_ds.main(["--workdir", str(wd), "submitJob", job]) == 0
    assert run_ds.main(["--workdir", str(wd), "startCluster", fleet]) == 0
    assert (wd / "worker_host.pid").exists()
    assert run_ds.main(["--workdir", str(wd), "monitor", "--poll", "0.2"]) == 0
    store = ObjectStore(str(wd / "store"))
    deadline = time.time() + 60
    while not store.exists("summary/PortDetached.json") and time.time() < deadline:
        time.sleep(0.2)
    assert store.get_json("summary/PortDetached.json")["jobs_done"] == 1
    res = store.get_json("serve/b0/RESULTS.json")
    assert sorted(res["requests"]) == ["req0", "req1", "req2"]
    assert all(len(r["completion"]) == 5 for r in res["requests"].values())
