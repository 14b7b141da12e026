"""The paper's four one-line commands, for the PyTorch/CUDA port.

    python -m repro_torch.launch.run_ds setup        --workdir W --config files/config.json
    python -m repro_torch.launch.run_ds submitJob    --workdir W files/job.json
    python -m repro_torch.launch.run_ds startCluster --workdir W files/fleet.json
    python -m repro_torch.launch.run_ds monitor      --workdir W [--cheapest]

The port's counterpart of the reference package's ``launch/run_ds.py``,
with the same arguments and state layout; the payloads run on the card
unless a job names ``"device": "cpu"``.

State layout under ``--workdir`` (the control node's view):
    config.json                         run configuration (Step 1)
    store/                              the object store (S3 analogue)
    store/_runtime/<queue>.sqlite       the durable queue (SQS analogue)
    <APP_NAME>SpotFleetRequestId.json   written by startCluster (Step 3)

``startCluster`` spawns a detached *worker host* process (the EC2 fleet
analogue) that places workers and drains the queue; ``monitor`` polls the
queue, reports progress, and finishes when everything is drained — so the
four commands can run from separate shells, like the paper's.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from repro_torch.core import DSConfig, DurableQueue, FleetFile, ObjectStore
from repro_torch.core.config import load_config, load_fleet_file
from repro_torch.core.jobs import load_job_file


def _paths(workdir: str):
    return {
        "config": os.path.join(workdir, "config.json"),
        "store": os.path.join(workdir, "store"),
        "fleet": os.path.join(workdir, "fleet.json"),
        "pid": os.path.join(workdir, "worker_host.pid"),
    }


def _queue(cfg: DSConfig, paths) -> DurableQueue:
    qpath = os.path.join(paths["store"], "_runtime", f"{cfg.sqs_queue_name}.sqlite")
    return DurableQueue(
        qpath,
        default_visibility=cfg.sqs_message_visibility,
        max_receive_count=cfg.max_receive_count,
    )


def cmd_setup(args) -> int:
    os.makedirs(args.workdir, exist_ok=True)
    cfg = load_config(args.config) if args.config else DSConfig()
    cfg.validate()
    paths = _paths(args.workdir)
    with open(paths["config"], "w") as f:
        f.write(cfg.to_json())
    _queue(cfg, paths)  # creates queue + DLQ tables
    print(f"setup complete: app={cfg.app_name} queue={cfg.sqs_queue_name}")
    return 0


def cmd_submit(args) -> int:
    paths = _paths(args.workdir)
    cfg = load_config(paths["config"])
    jf = load_job_file(args.jobfile)
    q = _queue(cfg, paths)
    bodies = jf.expand()
    q.send_batch(bodies)
    print(f"submitted {len(bodies)} jobs to {cfg.sqs_queue_name}")
    return 0


def cmd_start_cluster(args) -> int:
    paths = _paths(args.workdir)
    cfg = load_config(paths["config"])
    ff = load_fleet_file(args.fleetfile) if args.fleetfile else FleetFile()
    with open(paths["fleet"], "w") as f:
        f.write(ff.to_json())
    store = ObjectStore(paths["store"])
    store.put_json(
        f"{cfg.app_name}SpotFleetRequestId.json",
        {"app_name": cfg.app_name, "workdir": os.path.abspath(args.workdir)},
    )
    if args.foreground:
        from repro_torch.launch.worker_host import run_worker_host

        return run_worker_host(args.workdir)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.worker_host", "--workdir", args.workdir],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        start_new_session=True,
        env={**os.environ, "PYTHONPATH": os.environ.get("PYTHONPATH", "")},
    )
    with open(paths["pid"], "w") as f:
        f.write(str(proc.pid))
    print(f"spot fleet requested; worker host pid={proc.pid}")
    return 0


def cmd_monitor(args) -> int:
    paths = _paths(args.workdir)
    cfg = load_config(paths["config"])
    q = _queue(cfg, paths)
    t0 = time.time()
    while True:
        c = q.counts()
        host_alive = False
        if os.path.exists(paths["pid"]):
            pid = int(open(paths["pid"]).read().strip())
            try:
                os.kill(pid, 0)
                host_alive = True
            except OSError:
                host_alive = False
        print(
            f"[monitor t={time.time() - t0:6.1f}s] visible={c['visible']} "
            f"in_flight={c['in_flight']} dead={c['dead']} worker_host={'up' if host_alive else 'down'}"
        )
        if c["visible"] == 0 and c["in_flight"] == 0:
            print("queue drained; monitor exiting (teardown handled by worker host)")
            return 0
        if not host_alive and c["visible"] > 0:
            print("WARNING: worker host down with jobs remaining")
        time.sleep(args.poll)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_ds", description=__doc__)
    ap.add_argument("--workdir", default="./ds_workdir")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("setup")
    p.add_argument("--config", default=None)
    p.set_defaults(fn=cmd_setup)

    p = sub.add_parser("submitJob")
    p.add_argument("jobfile")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("startCluster")
    p.add_argument("fleetfile", nargs="?", default=None)
    p.add_argument("--foreground", action="store_true")
    p.set_defaults(fn=cmd_start_cluster)

    p = sub.add_parser("monitor")
    p.add_argument("--cheapest", action="store_true")
    p.add_argument("--poll", type=float, default=1.0)
    p.set_defaults(fn=cmd_monitor)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
