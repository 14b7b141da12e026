"""Worker host: the process that plays the EC2 spot fleet + ECS placement.

Spawned (detached) by ``run_ds startCluster``; builds the DSRuntime over
the shared on-disk queue/store, registers the payload "Somethings", runs
the ThreadRunner until the queue drains, then tears down and exports logs
— the automatic actions of the paper's Step 3/4.  The port's
counterpart of the reference package's ``launch/worker_host.py``.
"""

from __future__ import annotations

import argparse
import os

# register the payload Somethings
import repro_torch.launch.serve  # noqa: F401
import repro_torch.launch.train  # noqa: F401
from repro_torch.core import DSRuntime, FleetFile, ThreadRunner
from repro_torch.core.config import load_config, load_fleet_file


def run_worker_host(workdir: str) -> int:
    cfg = load_config(os.path.join(workdir, "config.json"))
    fleet_path = os.path.join(workdir, "fleet.json")
    ff = load_fleet_file(fleet_path) if os.path.exists(fleet_path) else FleetFile()

    rt = DSRuntime(cfg, store_root=os.path.join(workdir, "store"))
    rt.setup()  # reattaches to the existing sqlite queue (same path)
    rt.start_cluster(ff)
    runner = ThreadRunner(rt)
    summary = runner.run()
    rt.store.put_json(
        f"summary/{cfg.app_name}.json",
        {
            "jobs_done": summary.jobs_done,
            "jobs_skipped": summary.jobs_skipped,
            "jobs_failed": summary.jobs_failed,
            "idle_terminations": summary.idle_terminations,
            "wall_time": summary.wall_time,
        },
    )
    pid_file = os.path.join(workdir, "worker_host.pid")
    if os.path.exists(pid_file):
        os.unlink(pid_file)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    args = ap.parse_args(argv)
    return run_worker_host(args.workdir)


if __name__ == "__main__":
    raise SystemExit(main())
