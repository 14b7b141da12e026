"""Batched serving through the DS control plane (``distributed-serve``),
on the PyTorch port (``repro_torch``).

Default mode: request batches are queue jobs; each worker runs the
continuous-batching engine over its batch and uploads completions —
Distributed-OmeZarrCreator's "convert a dataset per job" pattern
transplanted to inference.

    PYTHONPATH=src python examples_torch/serve_batch.py

``--staggered``: the queue-fed serving tier.  One job is a *serving
lease*; individual requests are messages on a second DurableQueue, and
a submitter thread trickles them in over time while the engine is
already generating.  Freed rows are refilled mid-flight (continuous
batching) — watch the queue-wait/TTFT tick percentiles in the printed
summary; a drain-then-refill loop would stack arrivals behind the whole
batch.

    PYTHONPATH=src python examples_torch/serve_batch.py --staggered

The jobs run on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.launch.serve  # noqa: F401
import repro_torch.launch.train  # noqa: F401
from repro_torch.core import DSConfig, DSRuntime, FleetFile, JobFile, ThreadRunner
from repro_torch.core.queue import DurableQueue

SHARED = {
    "arch": "ds-paper-100m",
    "arch_overrides": "reduced",
    "max_new_tokens": 6,
    "max_len": 64,
    "max_batch": 2,
    # serving perf knobs: chunked prefill ingests whole
    # prompt slices per dispatch; fused mode issues ONE decode dispatch
    # per tick for any position mix
    "prefill_chunk": 8,
    "dispatch_mode": "fused",
    # paged KV cache: memory scales with resident tokens, not
    # max_batch * max_len; RESULTS.json gains peak_cache_bytes.
    # total_pages is omitted, so each worker sizes its pool adaptively
    # from the queue depth at submit (logged); the prefix cache (on by
    # default) shares system-prompt pages across requests instead of
    # re-prefilling
    "cache_mode": "paged",
    "page_size": 8,
}
SYS_PROMPT = [101, 102, 103, 104, 105, 106, 107, 108]


def _runtime(workdir):
    cfg = DSConfig(
        app_name="ServeBatch",
        payload="distributed-serve",
        cluster_machines=2,
        machine_type=["sim.large"],
        machine_price=1.0,
        sqs_message_visibility=300.0,
        check_if_done=True,
    )
    rt = DSRuntime(cfg, store_root=os.path.join(workdir, "store"))
    rt.setup()
    return rt


def main_batched(device: str) -> int:
    rt = _runtime(tempfile.mkdtemp(prefix="ds-serve-"))
    # batch2 shares an 8-token system prefix across its requests: with the
    # paged prefix cache the shared pages are prefilled once and stitched
    # into later requests' page tables (prompt_tokens_skipped > 0)
    batches = [
        {"prompts": [[1, 2, 3], [4, 5, 6, 7], [11]], "output_prefix": "serve/batch0"},
        {"prompts": [[8, 9], [10, 11, 12]], "output_prefix": "serve/batch1"},
        {"prompts": [SYS_PROMPT + [31], SYS_PROMPT + [32], SYS_PROMPT + [33]],
         "output_prefix": "serve/batch2"},
    ]
    rt.submit_job(JobFile(shared={**SHARED, "device": device}, groups=batches))
    rt.start_cluster(FleetFile(startup_seconds=0.1))
    summary = ThreadRunner(rt).run()
    print(f"served {summary.jobs_done} batches in {summary.wall_time:.1f}s")

    for i in range(len(batches)):
        res = rt.store.get_json(f"serve/batch{i}/RESULTS.json")
        for uid, r in sorted(res["requests"].items()):
            print(f"batch{i} {uid}: prompt={r['prompt']} -> completion={r['completion']}")
        # every token that crossed the device (emitted + ingested) counts
        toks = max(1, res["tokens_emitted"] + res["prompt_tokens_ingested"])
        print(
            f"batch{i} dispatches: decode={res['decode_dispatches']} "
            f"prefill={res['prefill_dispatches']} "
            f"dispatches/token={res['dispatches'] / toks:.2f} "
            f"prompt_tokens_ingested={res['prompt_tokens_ingested']} "
            f"prompt_tokens_skipped={res['prompt_tokens_skipped']} "
            f"peak_cache={res['peak_cache_bytes']}B "
            f"(dense would reserve {res['dense_cache_bytes']}B, "
            f"pool={res['total_pages']} pages)"
        )
    return 0


def main_staggered(device: str) -> int:
    workdir = tempfile.mkdtemp(prefix="ds-serve-stream-")
    rt = _runtime(workdir)
    rq_path = os.path.join(workdir, "requests.sqlite")
    rq = DurableQueue(rq_path)

    # three arrival waves, ~0.2s apart: wave 1 saturates the two slots,
    # waves 2-3 land while the engine is mid-generation and are admitted
    # into rows as they free up — never waiting for a full batch drain
    waves = [
        [{"uid": f"w0r{i}", "prompt": SYS_PROMPT + [30 + i]} for i in range(3)],
        [{"uid": f"w1r{i}", "prompt": SYS_PROMPT + [40 + i]} for i in range(3)],
        [{"uid": f"w2r{i}", "prompt": [50 + i, 51 + i]} for i in range(2)],
    ]
    n_total = sum(len(w) for w in waves)

    def submitter():
        for wave in waves:
            rq.send_batch(wave)
            time.sleep(0.2)

    rt.submit_job(JobFile(
        shared={**SHARED, "device": device},
        groups=[{
            "request_queue": rq_path,
            "expected_requests": n_total,
            # generous idle budget: the lease must outlive arrival gaps
            "stream_idle_polls": 200,
            "stream_poll_seconds": 0.02,
            "output_prefix": "serve/stream0",
        }],
    ))
    t = threading.Thread(target=submitter, daemon=True)
    t.start()
    rt.start_cluster(FleetFile(startup_seconds=0.1))
    summary = ThreadRunner(rt).run()
    t.join()
    print(f"stream lease finished in {summary.wall_time:.1f}s "
          f"({summary.jobs_done} lease job)")

    res = rt.store.get_json("serve/stream0/RESULTS.json")
    for uid, r in sorted(res["requests"].items()):
        print(f"stream {uid}: prompt={r['prompt']} -> completion={r['completion']}")
    tm = res["timing"]
    print(
        f"continuous batching: {res['admissions']} admissions over "
        f"{res['ticks']} ticks on {SHARED['max_batch']} slots "
        f"(prompt_tokens_skipped={res['prompt_tokens_skipped']} via the "
        f"shared system prefix)"
    )
    print(
        f"queue_wait ticks: mean={tm['queue_wait_ticks']['mean']} "
        f"p90={tm['queue_wait_ticks']['p90']}  |  ttft ticks: "
        f"mean={tm['ttft_ticks']['mean']} p90={tm['ttft_ticks']['p90']}"
    )
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--staggered", action="store_true",
                    help="queue-fed serving lease with staggered arrivals")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    return main_staggered(args.device) if args.staggered else main_batched(args.device)


if __name__ == "__main__":
    raise SystemExit(main())
