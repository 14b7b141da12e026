"""Training spans and evaluation over an object store, and the
``distributed-train`` and ``distributed-eval`` payloads.

Counterparts of the reference package's ``launch/train.py`` payloads,
with the same job keys and defaults:

- :func:`run_train_span` trains the step span ``[start_step,
  start_step + num_steps)``: it restores the latest checkpoint (or
  initialises at step 0), raises :class:`NotReady` when the span's
  prerequisite checkpoint is missing, checkpoints every ``ckpt_every``
  steps and at the span's end, and writes ``DONE.json``;
- :func:`run_eval` restores the run's latest checkpoint and writes the
  mean loss and perplexity over ``n_batches`` synthetic batches to
  ``METRICS.json``.

Both take an ``ObjectStore`` and a ``heartbeat(progress=...)`` callable,
called after every step or batch; the payloads registered here pass the
worker's store and ``ctx.heartbeat`` and run on the job's ``device``
(``cuda`` when the job names none: on a host without a card the job
fails, and is never run on the CPU unasked).  Checkpoints are in the
reference's format, so a span can resume from the reference's checkpoint
and the other way round.  One job key is the port's own: ``dtype`` (``"float32"``,
the reference's default, or ``"bfloat16"``).  Attention follows
``ModelRuntime.resolve_attn`` and an SSM's scan ``resolve_ssd``: the plain
paths while training, the flash and SSD kernels for eval on the card.  An
SSM's ``A_log``, ``D`` and ``dt_bias`` stay float32 in a bf16 run, in its
checkpoints as in its parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.core.storage import ObjectStore
from repro_torch.core.worker import NotReady, WorkerContext, register_payload
from repro_torch.models import Model, ModelRuntime
from repro_torch.train.checkpoint import latest_step, restore_state, save_state
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import AdamWConfig, Schedule, init_opt_state
from repro_torch.train.steps import TrainStepConfig, make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(job: Dict) -> Model:
    cfg = get_arch(job["arch"])
    overrides = job.get("arch_overrides")
    if overrides == "reduced":
        cfg = reduced(cfg)
    elif isinstance(overrides, dict):
        cfg = dataclasses.replace(cfg, **overrides)
    return Model(cfg, ModelRuntime(dtype=DTYPES[job.get("dtype", "float32")],
                                   moe_strategy=job.get("moe_strategy", "dense")))


def build_train_step(job: Dict, model: Model):
    opt = AdamWConfig(
        schedule=Schedule(
            peak_lr=job.get("lr", 3e-4),
            warmup_steps=job.get("warmup_steps", 20),
            total_steps=job.get("total_steps", 1000),
        ),
        weight_decay=job.get("weight_decay", 0.1),
        moments_dtype=job.get("moments_dtype", "f32"),
    )
    tcfg = TrainStepConfig(
        microbatches=job.get("microbatches", 1),
        accum_dtype=job.get("accum_dtype", "f32"),
        opt=opt,
    )
    return make_train_step(model, tcfg), opt


def run_train_span(job: Dict, store: ObjectStore, heartbeat: Callable, device=None) -> Dict:
    """Train one step span; returns (and writes as ``DONE.json``) the
    span's result."""
    device = resolve_device(device)
    run = job.get("run", "run0")
    start, num = int(job["start_step"]), int(job["num_steps"])
    end = start + num
    ckpt_every = int(job.get("ckpt_every", max(1, num)))

    model = build_model(job)
    train_step, opt_cfg = build_train_step(job, model)
    data = SyntheticLM(model.cfg, DataConfig(seq_len=job.get("seq_len", 64),
                                             global_batch=job.get("global_batch", 4),
                                             seed=job.get("data_seed", 0)), device=device)

    # ---- restore or init ---------------------------------------------------
    have = latest_step(store, run)
    if start == 0 and (have is None or have < 0):
        params = model.init(job.get("init_seed", 0), device=device)
        opt_state = init_opt_state(params, opt_cfg)
        state_step = 0
    else:
        if have is None or have < start:
            raise NotReady(
                f"span [{start},{end}) prerequisite checkpoint missing (latest={have})",
                retry_in=float(job.get("prereq_retry_s", 10.0)),
            )
        resume = min(have, end)
        params, _ = restore_state(store, run, resume, model.abstract_params(), device=device)
        try:
            opt_state, _ = restore_state(store, f"{run}-opt", resume,
                                         init_opt_state(model.abstract_params(), opt_cfg),
                                         device=device)
        except Exception:
            opt_state = init_opt_state(params, opt_cfg)  # opt state lost: cold moments
        state_step = resume
        opt_state["step"] = state_step

    losses = []
    for step in range(state_step, end):
        batch = data.batch(step)
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                prng.PRNGKey(step, device=device))
        losses.append(float(metrics["loss"]))
        heartbeat(progress=f"step {step + 1}/{end} loss={losses[-1]:.4f}")
        done_step = step + 1
        if done_step % ckpt_every == 0 or done_step == end:
            save_state(store, run, done_step, params, extra_meta={"loss": losses[-1]})
            save_state(store, f"{run}-opt", done_step, opt_state)

    result = {"run": run, "span": [start, end], "steps_run": len(losses),
              "final_loss": losses[-1] if losses else None, "losses": losses}
    out = job.get("output_prefix", f"runs/{run}/spans/{start:06d}-{end:06d}")
    store.put_json(f"{out}/DONE.json", {k: v for k, v in result.items() if k != "losses"})
    return result


@torch.no_grad()
def run_eval(job: Dict, store: ObjectStore, heartbeat: Callable, device=None) -> Dict:
    """Perplexity over a deterministic shard of the synthetic stream."""
    device = resolve_device(device)
    run = job.get("run", "run0")
    model = build_model(job)
    data = SyntheticLM(model.cfg, DataConfig(seq_len=job.get("seq_len", 64),
                                             global_batch=job.get("global_batch", 4),
                                             seed=job.get("data_seed", 1234)), device=device)
    step_ck = latest_step(store, run)
    if step_ck is None:
        raise RuntimeError(f"no checkpoint for run {run!r}")
    params, _ = restore_state(store, run, step_ck, model.abstract_params(), device=device)

    shard_idx = int(job.get("shard", 0))
    n_batches = int(job.get("n_batches", 4))
    losses = []
    for i in range(n_batches):
        batch = data.batch(shard_idx * n_batches + i)
        losses.append(float(model.loss(params, batch)[0]))
        heartbeat(progress=f"eval batch {i + 1}/{n_batches}")
    mean = sum(losses) / len(losses)
    result = {"run": run, "shard": shard_idx, "ckpt_step": step_ck, "loss": mean,
              "ppl": float(np.exp(np.float32(mean)))}
    out = job.get("output_prefix", f"runs/{run}/eval/shard{shard_idx}")
    store.put_json(f"{out}/METRICS.json", result)
    return result


@register_payload("distributed-train")
def train_payload(job: Dict, ctx: WorkerContext) -> Dict:
    """One step span of a training run (see :func:`run_train_span`)."""
    return run_train_span(job, ctx.store, ctx.heartbeat, device=job.get("device"))


@register_payload("distributed-eval")
def eval_payload(job: Dict, ctx: WorkerContext) -> Dict:
    """Perplexity of one shard on the run's latest checkpoint (see
    :func:`run_eval`)."""
    return run_eval(job, ctx.store, ctx.heartbeat, device=job.get("device"))
