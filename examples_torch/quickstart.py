"""Quickstart: the paper's four commands driving a real training run.

Trains the ~100M-parameter LM (``ds-paper-100m``) for a configurable
number of steps as checkpoint-delimited step-span jobs, distributed over
a simulated spot fleet of local workers — the complete end-to-end driver
(data pipeline -> train steps -> checkpoints -> monitor teardown), on the
PyTorch port (``repro_torch``).  Each span's train step updates the
parameters and optimizer state in place (the donated step).

    PYTHONPATH=src python examples_torch/quickstart.py --steps 20 --span 5 --workers 2
    PYTHONPATH=src python examples_torch/quickstart.py --steps 300 --span 50 --full-size
    PYTHONPATH=src python examples_torch/quickstart.py --steps 4 --span 2 --device cpu

The jobs run on the CUDA card unless ``--device cpu`` is given.  Defaults
run a reduced-width model so the demo completes in ~a minute; ``--full-size``
uses the real 12L/768d config (sized for one H100).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.launch.train  # noqa: F401  registers distributed-train
from repro_torch.core import DSConfig, DSRuntime, FleetFile, ThreadRunner, step_span_job_file
from repro_torch.train.checkpoint import latest_step


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--span", type=int, default=5)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    workdir = args.workdir or tempfile.mkdtemp(prefix="ds-quickstart-")
    print(f"workdir: {workdir}")

    # Step 1: Configuration  (paper: edit config.py, `python run.py setup`)
    cfg = DSConfig(
        app_name="Quickstart",
        payload="distributed-train",
        cluster_machines=args.workers,
        tasks_per_machine=1,
        machine_type=["sim.xlarge"],
        machine_price=2.0,
        sqs_message_visibility=600.0,
        check_if_done=True,
        expected_number_files=1,
    )
    rt = DSRuntime(cfg, store_root=os.path.join(workdir, "store"))
    rt.setup()

    # Step 2: Submit jobs  (`python run.py submitJob files/job.json`)
    job_file = step_span_job_file(
        arch="ds-paper-100m",
        total_steps=args.steps,
        span=args.span,
        run="quickstart",
        shared={
            "arch_overrides": None if args.full_size else "reduced",
            "seq_len": args.seq_len,
            "global_batch": args.batch,
            "lr": 3e-4,
            "warmup_steps": max(2, args.steps // 10),
            "total_steps": args.steps,
            "ckpt_every": args.span,
            "device": args.device,
        },
    )
    n = rt.submit_job(job_file)
    print(f"submitted {n} step-span jobs")

    # Step 3: Start cluster  (`python run.py startCluster files/fleet.json`)
    request_id = rt.start_cluster(FleetFile(startup_seconds=0.1))
    print(f"spot fleet: {request_id}")

    # Step 4: Monitor  (`python run.py monitor ...`) — ThreadRunner runs the
    # workers and the monitor loop until the queue drains, then tears down.
    summary = ThreadRunner(rt).run()
    print(
        f"done: jobs={summary.jobs_done} skipped={summary.jobs_skipped} "
        f"failed(retried)={summary.jobs_failed} wall={summary.wall_time:.1f}s"
    )

    step = latest_step(rt.store, "quickstart")
    print(f"final checkpoint step: {step}")
    for span_start in range(0, args.steps, args.span):
        key = (
            f"runs/quickstart/spans/{span_start:06d}-"
            f"{min(span_start + args.span, args.steps):06d}/DONE.json"
        )
        if rt.store.exists(key):
            d = rt.store.get_json(key)
            print(f"  span {d['span']}: final_loss={d['final_loss']:.4f}")
    assert step == args.steps, "training did not reach the final step"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
