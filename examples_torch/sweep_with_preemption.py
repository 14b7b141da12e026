"""Hyper-parameter sweep on a preemptible fleet — the paper's core use
case ("many small machines" processing independent groups), plus the
fault-tolerance story: instances are spot-preempted mid-run and the
queue's visibility timeout re-delivers their jobs to survivors.

Each job group is an independent learning-rate run of the reduced 100M
model on the PyTorch port (``repro_torch``); the deterministic market
seed makes the preemption schedule reproducible.

Workers here claim jobs in batches (``SimRunner(prefetch=2)`` drives
``DurableQueue.receive_batch`` under one lock/transaction instead of a
round-trip per job); a job buffered on a preempted instance simply
resurfaces after its visibility timeout — same at-least-once story as a
crash — and the monitor's teardown sweep batch-acks any straggler that
reappears between the drain check and queue purge.

    PYTHONPATH=src python examples_torch/sweep_with_preemption.py
    PYTHONPATH=src python examples_torch/sweep_with_preemption.py --device cpu

The jobs run on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.launch.train  # noqa: F401
from repro_torch.core import (
    DSConfig,
    DSRuntime,
    FleetFile,
    JobFile,
    SimRunner,
    VirtualClock,
)

LRS = [1e-4, 3e-4, 1e-3, 3e-3]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    workdir = tempfile.mkdtemp(prefix="ds-sweep-")
    clk = VirtualClock()
    cfg = DSConfig(
        app_name="LRSweep",
        payload="distributed-train",
        cluster_machines=3,
        machine_type=["sim.large"],
        machine_price=1.0,
        sqs_message_visibility=300.0,
        max_receive_count=6,
        check_if_done=True,
    )
    rt = DSRuntime(cfg, store_root=os.path.join(workdir, "store"), clock=clk)
    rt.setup()

    jf = JobFile(
        shared={
            "arch": "ds-paper-100m",
            "arch_overrides": "reduced",
            "start_step": 0,
            "num_steps": 8,
            "total_steps": 8,
            "seq_len": 64,
            "global_batch": 2,
            "device": args.device,
        },
        groups=[
            {"lr": lr, "run": f"lr{lr:g}", "output_prefix": f"sweep/lr{lr:g}"}
            for lr in LRS
        ],
    )
    rt.submit_job(jf)

    # aggressive preemption: ~3 kills/instance/hour, deterministic seed
    rt.start_cluster(FleetFile(startup_seconds=0.0, preemption_rate_per_hour=3.0, market_seed=13))
    # prefetch=2: one receive_batch transaction claims two jobs; both are
    # processed within the 300s visibility lease at 120s ticks
    summary = SimRunner(rt, tick_seconds=120.0, prefetch=2).run(max_ticks=500)
    print(
        f"sweep complete: done={summary.jobs_done} preemptions={summary.preemptions} "
        f"virtual_time={summary.wall_time / 60:.0f}min"
    )

    print(f"{'lr':>8s} {'final loss':>12s}")
    best = None
    for lr in LRS:
        d = rt.store.get_json(f"sweep/lr{lr:g}/DONE.json")
        print(f"{lr:8g} {d['final_loss']:12.4f}")
        if best is None or d["final_loss"] < best[1]:
            best = (lr, d["final_loss"])
    print(f"best lr: {best[0]:g} (loss {best[1]:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
