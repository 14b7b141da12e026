"""``distributed-serve`` — the serving "Something".

Counterpart of the reference package's ``launch/serve.py``, with the same
job keys, defaults, object-store layout and counters.  Two shapes of
serving job, sharing one engine construction path:

- **static batch**: the job carries ``prompts``; the worker builds the
  model, runs the continuous-batching engine over the batch, and writes
  completions + the full engine counter snapshot to
  ``{output_prefix}/RESULTS.json``.  Each engine dispatch heartbeats.
- **queue-streaming** (``request_queue`` set): the job is a *serving
  lease*, not a batch.  The worker opens the named
  :class:`~repro_torch.core.queue.DurableQueue` of per-request messages
  and streams them into the scheduler — admission happens mid-flight
  into freed rows, each completed request's record is written to the
  object store BEFORE its message is acknowledged (durable-before-ack),
  and in-flight request leases are extended on the heartbeat cadence.
  A worker crash (or a ``Preempted`` heartbeat) resurfaces every
  unfinished request via the visibility timeout; a client uid reused for
  a different prompt is served under a renamed uid, and a redelivery of
  a request already served is acked without serving it again.

**Elastic leases** (``stream_slice_ticks`` > 0): the worker runs at most
that many engine ticks per claim, then raises
:class:`~repro_torch.core.worker.LeaseYield` — the lease message is
released (budget refunded) and re-claimed next tick, its warm engine
state cached per worker in between (``_LEASE_STATES``).  On a
spot-revocation notice (``WorkerContext.revoked()``) the lease drains
gracefully: each active generation is checkpointed (a sealed record of
its prompt, output and sampling position under
``{out}/checkpoints/``), active rows are preempted back, in-flight
request messages made visible immediately (receive counts intact, so
poison requests still march to the DLQ), the segment's counters
persisted under ``{out}/leases/``, and the permit yielded.  A resuming
lease admits a redelivered request from its checkpoint when the record
verifies (:func:`_try_resume`): its output continues token for token
from where the drained worker stopped, stitching the KV pages the drained
worker published through the prefix store.  Models and seed-initialised
parameters are memoized process-wide (``_MODEL_CACHE``,
``_PARAM_CACHE``).

Engine knobs accepted from the job dict: ``max_batch``, ``max_len``,
``prefill_chunk``, ``dispatch_mode``, ``sample_on_device``,
``cache_mode``, ``page_size``, ``total_pages`` (omitted => adaptive),
``prefix_cache``, ``prefix_match``, ``refill_policy``,
``prefill_token_budget``, the speculative knobs ``speculative``
(``off`` | ``ngram`` | ``draft``), ``spec_k``, ``draft_arch``,
``draft_arch_overrides`` and ``draft_init_seed``, and the cross-host
prefix store (``prefix_store`` truthy + optional
``prefix_store_namespace``): completed prompts' KV pages are
content-hashed into the shared object store and cold workers hydrate
them instead of prefilling.  Two keys are the port's own: ``dtype``
(``"float32"``, the default, or ``"bfloat16"``) and ``device`` (default
``cuda``: a job without it fails on a host without a card and is never
served on the CPU unasked).

**Disaggregated prefill/decode** (``worker_role``): ``prefill`` leases
chunk-prefill prompts from the request queue, publish each prompt's
full KV chain through the prefix store (chain keys pinned against the
TTL sweep), and enqueue a sealed handoff record onto ``decode_queue``,
with a marker under ``{out}/handoffs/``; they never decode a token.
``decode`` leases claim handoff records (their ``request_queue`` is the
decode queue), demand-hydrate exactly the chained pages and decode to
completion; a record that fails its seal check is never admitted and
marches to the DLQ (``handoff_seal_rejects``).
"""

from __future__ import annotations

import hashlib
import json
from typing import Callable, Dict, Optional, Tuple

from repro_torch import resolve_device
from repro_torch.core.queue import DurableQueue
from repro_torch.core.worker import (
    LeaseYield,
    NotReady,
    WorkerContext,
    backoff_delay,
    register_payload,
)
from repro_torch.launch.train import build_model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.prefix_store import PrefixStore
from repro_torch.train.checkpoint import latest_step, restore_state

# process-wide caches: a serving fleet rebuilds engines constantly
# (slice resumes after takeover, post-revocation replacements), and model
# construction and seed-init dominate a cold build.  Both are
# content-keyed, so concurrent workers racing a cold key build identical
# values and the last writer wins on one dict store.
_MODEL_CACHE: Dict[tuple, object] = {}
_PARAM_CACHE: Dict[tuple, object] = {}
# warm lease state, keyed (worker_id, request_queue, output_prefix):
# survives LeaseYield between claims by the same worker; dropped on
# completion, drain, or crash.  Keys embed the worker id, so each worker
# thread only touches its own entries.
_LEASE_STATES: Dict[tuple, "_LeaseState"] = {}


def reset_serve_state() -> None:
    """Drop all cached lease state.  Tests and benchmarks call this
    between independent simulated runs: worker ids repeat across fresh
    runtimes, and a stale warm engine would otherwise let state
    "survive" a simulated crash.  Model/param caches are kept — they are
    content-keyed and runs legitimately share them."""
    for st in list(_LEASE_STATES.values()):
        try:
            st.rq.close()
        except Exception:
            pass
        try:
            if st.dq is not None:
                st.dq.close()
        except Exception:
            pass
    _LEASE_STATES.clear()


def _freeze(value):
    if isinstance(value, dict):
        return tuple(sorted(value.items()))
    return value


def _model_key(job: Dict) -> tuple:
    return (
        job.get("arch"),
        _freeze(job.get("arch_overrides")),
        job.get("moe_strategy", "dense"),
        job.get("dtype", "float32"),
    )


def _cached_model(job: Dict):
    try:
        key = _model_key(job)
        hash(key)
    except TypeError:  # exotic unhashable overrides: build uncached
        return build_model(job)
    model = _MODEL_CACHE.get(key)
    if model is None:
        model = _MODEL_CACHE[key] = build_model(job)
    return model


def _seed_params(job: Dict, model, seed: int, device):
    """Seed-initialised parameters, memoized on (model, seed, device):
    they are pure functions of those (checkpoint params are NOT cached —
    the run's latest step advances)."""
    try:
        pkey = (_model_key(job), seed, str(device))
        hash(pkey)
    except TypeError:
        return model.init(seed, device=device)
    params = _PARAM_CACHE.get(pkey)
    if params is None:
        params = _PARAM_CACHE[pkey] = model.init(seed, device=device)
    return params


def _build_params(job: Dict, ctx: WorkerContext, model, device) -> Tuple[object, str]:
    """Model parameters + a string pinning their identity: the latest
    checkpoint of ``run`` (written by either package, restored with
    ``restore_state``) or a seed init."""
    run = job.get("run")
    if run:
        step = latest_step(ctx.store, run)
        if step is None:
            raise RuntimeError(f"no checkpoint for run {run!r}")
        params, _ = restore_state(ctx.store, run, step, model.abstract_params(), device=device)
        return params, f"run={run}@{step}"
    seed = int(job.get("init_seed", 0))
    return _seed_params(job, model, seed, device), f"seed={seed}"


def _build_engine(job: Dict, ctx: WorkerContext) -> ServeEngine:
    device = resolve_device(job.get("device"))
    model = _cached_model(job)
    params, param_id = _build_params(job, ctx, model, device)
    cache_mode = str(job.get("cache_mode", "dense"))
    if job.get("prefix_store") and cache_mode != "paged":
        raise ValueError(
            "job sets prefix_store but cache_mode is not 'paged'; the "
            "cross-host prefix store would be silently inert"
        )
    paged_kwargs = {}
    if cache_mode == "paged":
        page_size = int(job.get("page_size", 16))
        paged_kwargs["page_size"] = page_size
        # omitted total_pages => the engine sizes the pool adaptively from
        # the queue depth at submit
        if job.get("total_pages"):
            paged_kwargs["total_pages"] = int(job["total_pages"])
        paged_kwargs["prefix_cache"] = bool(job.get("prefix_cache", True))
        paged_kwargs["prefix_match"] = str(job.get("prefix_match", "token"))
        if job.get("prefix_store"):
            # the namespace pins what page bytes depend on: arch, params,
            # dtype and page size (PrefixStore adds the framework tag)
            namespace = str(
                job.get("prefix_store_namespace")
                or f"{job.get('arch', 'arch')}/{job.get('arch_overrides', '')}"
                f"/{param_id}/{job.get('dtype', 'float32')}/ps{page_size}"
            )
            paged_kwargs["prefix_store"] = PrefixStore(ctx.store, namespace)
    budget = job.get("prefill_token_budget")  # 0 reaches the scheduler's
    #                                           validation and is refused
    speculative = str(job.get("speculative", "off"))
    spec_kwargs = {}
    if speculative != "off":
        spec_kwargs["speculative"] = speculative
        spec_kwargs["spec_k"] = int(job.get("spec_k", 4))
        if speculative == "draft":
            # the draft model is built like the target (arch name +
            # optional overrides, the target's dtype), random-init by
            # draft_init_seed: drafts are only proposals, the target
            # model still decides every token
            draft_job = {
                "arch": job.get("draft_arch", "ds-paper-100m"),
                "arch_overrides": job.get("draft_arch_overrides", "reduced"),
                "dtype": job.get("dtype", "float32"),
            }
            draft_model = _cached_model(draft_job)
            spec_kwargs["draft_model"] = draft_model
            spec_kwargs["draft_params"] = _seed_params(
                draft_job, draft_model, int(job.get("draft_init_seed", 0)), device)
    return ServeEngine(
        model,
        params,
        max_batch=int(job.get("max_batch", 4)),
        max_len=int(job.get("max_len", 128)),
        prefill_chunk=int(job.get("prefill_chunk", 16)),
        dispatch_mode=str(job.get("dispatch_mode", "fused")),
        sample_on_device=bool(job.get("sample_on_device", True)),
        cache_mode=cache_mode,
        refill_policy=str(job.get("refill_policy", "continuous")),
        prefill_token_budget=int(budget) if budget is not None else None,
        worker_role=str(job.get("worker_role", "unified")),
        heartbeat=lambda: ctx.heartbeat(),
        device=device,
        **paged_kwargs,
        **spec_kwargs,
    )


def _request_from(body: Dict, job: Dict, fallback_uid: str) -> Request:
    stop = body.get("stop_token", job.get("stop_token"))
    return Request(
        uid=str(body.get("uid", fallback_uid)),
        prompt=[int(t) for t in body["prompt"]],
        max_new_tokens=int(body.get("max_new_tokens", job.get("max_new_tokens", 8))),
        temperature=float(body.get("temperature", job.get("temperature", 0.0))),
        stop_token=int(stop) if stop is not None else None,
    )


def _snapshot(engine: ServeEngine) -> Dict:
    """Full scheduler/cache counter snapshot, plus the legacy key aliases
    earlier RESULTS.json consumers grew up with."""
    snap = engine.snapshot()
    snap["engine_steps"] = snap["steps_executed"]
    if engine.cache_mode == "paged":
        snap["pages_in_use_peak"] = snap["peak_pages"]
    return snap


# --------------------------------------------- work-preserving recovery
def _with_retries(op: Callable, *, key: str, clock, attempts: int = 4,
                  base: float = 0.01, cap: float = 0.5):
    """Run a store/queue operation with capped content-keyed backoff
    against *transient* faults (``ConnectionError`` is what the chaos
    harness's ``flaky_storage``/``flaky_queue`` faults raise, and what a
    real S3/SQS SDK surfaces for retryable errors).  Anything else —
    including ``FileNotFoundError`` misses — propagates immediately."""
    for attempt in range(1, attempts + 1):
        try:
            return op()
        except ConnectionError:
            if attempt == attempts:
                raise
            clock.sleep(backoff_delay(base, attempt, cap=cap, key=key))


def _uid_safe(uid: str) -> str:
    return str(uid).replace("/", "~")


def _seal_checkpoint(ckpt: Dict) -> Dict:
    """Attach the sha256 of the canonical-JSON checkpoint body: the
    resume path re-derives it, so a torn write or bit-flipped record is
    detected and degrades to full replay instead of corrupting output."""
    body = json.dumps(ckpt, sort_keys=True, separators=(",", ":"))
    return {**ckpt, "sha": hashlib.sha256(body.encode("utf-8")).hexdigest()}


def _checkpoint_valid(ckpt: Dict, req: Request) -> bool:
    """A checkpoint is trusted only if its content hash verifies AND it
    describes exactly the request the queue message carries (the message
    is the source of truth; the checkpoint is an optimization)."""
    if not isinstance(ckpt, dict) or "sha" not in ckpt:
        return False
    body = {k: v for k, v in ckpt.items() if k != "sha"}
    digest = hashlib.sha256(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode("utf-8")
    ).hexdigest()
    if digest != ckpt["sha"]:
        return False
    try:
        output = [int(t) for t in ckpt["output"]]
        return (
            str(ckpt["uid"]) == req.uid
            and [int(t) for t in ckpt["prompt"]] == req.prompt
            and 0 < len(output) <= req.max_new_tokens
            and int(ckpt["max_new_tokens"]) == req.max_new_tokens
            and float(ckpt["temperature"]) == req.temperature
            and ckpt.get("stop_token") == req.stop_token
            and int(ckpt["sample_stream"]) >= 0
        )
    except (KeyError, TypeError, ValueError):
        return False


def _try_resume(engine: ServeEngine, ctx: WorkerContext, ckpt_prefix: str,
                req: Request) -> Optional[Request]:
    """Fallback ladder, rung one: admit ``req`` from its generation
    checkpoint.  Returns the resumed Request, or None — counting a
    ``checkpoint_fallback`` — when the checkpoint is missing, unreadable
    or fails validation; the caller then submits the request normally
    (full replay, token-for-token identical via the deterministic
    sampling streams)."""
    key = f"{ckpt_prefix}{_uid_safe(req.uid)}.json"
    try:
        ckpt = _with_retries(
            lambda: ctx.store.get_json(key), key=key, clock=ctx.clock
        )
    except FileNotFoundError:
        ckpt = None
    except Exception:  # noqa: BLE001 - unreadable/corrupt blob: replay
        ckpt = None
    if ckpt is None or not _checkpoint_valid(ckpt, req):
        engine.stats.checkpoint_fallbacks += 1
        return None
    return engine.submit_resume(ckpt)


# --------------------------------------- disaggregated prefill/decode
def _handoff_valid(rec) -> bool:
    """A decode-queue message is admitted only if its content hash
    verifies and it is shaped like a handoff: the checkpoint record
    format with an EMPTY output (nothing decoded yet).  There is no
    request to cross-check against: the sealed record IS the source of
    truth on the decode side."""
    if not isinstance(rec, dict) or "sha" not in rec:
        return False
    body = {k: v for k, v in rec.items() if k != "sha"}
    digest = hashlib.sha256(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode("utf-8")
    ).hexdigest()
    if digest != rec["sha"]:
        return False
    try:
        return (
            len(list(rec["output"])) == 0
            and len([int(t) for t in rec["prompt"]]) > 0
            and int(rec["sample_stream"]) >= 0
            and int(rec["max_new_tokens"]) > 0
        )
    except (KeyError, TypeError, ValueError):
        return False


def _publish_handoff(ctx: WorkerContext, st: "_LeaseState", r: Request, m) -> None:
    """Seal and enqueue one finished prefill onto the decode queue.

    Ordering is the handoff contract (durable-before-ack across three
    parties): (1) the prompt's KV chain (full pages plus the sub-page
    tail) is flushed durable in the prefix store; (2) every chain key is
    pinned so the TTL sweep cannot reclaim the pages before a decode
    worker admits them; (3) the sealed record lands on the decode queue;
    (4) the handoff marker is persisted (the prefill lease's completion
    record, which termination and uid dedup read); (5) only then is the
    request message acked.  A crash between any two steps redelivers the
    request and the sequence reruns idempotently."""
    engine = st.engine
    hand = _seal_checkpoint({
        "uid": r.uid,
        "prompt": [int(t) for t in r.prompt],
        "output": [],
        "sample_stream": int(r.sample_stream),
        "max_new_tokens": int(r.max_new_tokens),
        "temperature": float(r.temperature),
        "stop_token": r.stop_token,
    })
    engine.cache_mgr.flush_store()
    store = engine.cache_mgr.store
    for k in engine.cache_mgr.chain_keys_for(r.prompt):
        _with_retries(lambda k=k: store.pin(k), key=f"pin/{k}", clock=ctx.clock)
    _with_retries(lambda: st.dq.send(hand), key=f"handoff/{r.uid}", clock=ctx.clock)
    mark_key = f"{st.req_prefix}{r.uid}.json"
    _with_retries(lambda: ctx.store.put_json(mark_key, hand), key=mark_key, clock=ctx.clock)
    if m is not None:
        _with_retries(lambda: st.rq.delete(m), key=mark_key, clock=ctx.clock)
        st.acked += 1
    engine.stats.handoffs_published += 1


@register_payload("distributed-serve")
def serve_payload(job: Dict, ctx: WorkerContext) -> Dict:
    if job.get("request_queue"):
        # the streaming path builds (or resumes) its engine lazily: a
        # lease claimed after the fleet already finished never builds one
        return _serve_stream(job, ctx)

    engine = _build_engine(job, ctx)
    prompts = job["prompts"]  # list of token-id lists
    engine.submit(
        [_request_from({"prompt": p}, job, f"req{i}") for i, p in enumerate(prompts)]
    )
    finished = engine.run_to_completion()
    results = {
        r.uid: {"prompt": r.prompt, "completion": r.output} for r in finished
    }
    out = job.get("output_prefix", "serve/batch0")
    snap = _snapshot(engine)
    results_key = f"{out}/RESULTS.json"
    _with_retries(
        lambda: ctx.store.put_json(results_key, {"requests": results, **snap}),
        key=results_key, clock=ctx.clock,
    )
    return {"n_requests": len(finished), **snap}


class _LeaseState:
    """Warm per-worker serving state carried across lease slices."""

    __slots__ = (
        "key", "worker_id", "out", "req_prefix", "results_key", "ctx",
        "engine", "rq", "inflight", "served", "marks", "acked", "idle",
        "last_ext", "ckpt_prefix", "role", "dq",
    )

    def __init__(self, key, ctx, out, req_prefix, results_key, engine, rq):
        self.key = key
        self.worker_id = ctx.worker_id
        self.ctx = ctx
        self.out = out
        self.req_prefix = req_prefix
        self.results_key = results_key
        self.engine = engine
        self.rq = rq
        self.inflight: Dict[str, object] = {}  # uid -> queue Message
        self.served = set()
        self.marks = engine.scheduler.sample_marks()
        self.acked = 0  # THIS worker's acks (returned as n_requests)
        self.idle = 0
        self.last_ext = ctx.clock.now()
        # generation-checkpoint prefix (None = work-preserving recovery
        # disabled for this job); set right after construction
        self.ckpt_prefix: Optional[str] = None
        # disaggregation: the lease's role and, for prefill leases, the
        # decode queue handoffs are enqueued onto
        self.role = "unified"
        self.dq: Optional[DurableQueue] = None


def _report_progress(ctx: WorkerContext, st: _LeaseState) -> None:
    """Publish the autoscaler's inputs: shared request-queue backlog
    (every lease reports the same queue — the policy takes the max, not
    the sum) and this lease's latency percentiles in engine ticks."""
    qc = st.rq.counts()
    timing = st.engine.scheduler.timing(**st.marks)
    active = len(st.engine.scheduler.pending) + sum(
        1 for s in st.engine.slots if s.req is not None
    )
    ctx.report_progress({
        "kind": "serve",
        "role": st.role,
        "backlog": qc["visible"] + qc["in_flight"],
        "active": active,
        "p99_ttft": timing["ttft_ticks"]["p99"],
        "p99_queue_wait": timing["queue_wait_ticks"]["p99"],
        "served": len(st.served),
    })


def _persist_segment(ctx: WorkerContext, st: _LeaseState, wid_safe: str) -> None:
    """Overwrite this worker's cumulative segment counters under
    ``{out}/leases/``.  Called at every lease-slice yield and at drain,
    so a worker whose permit is never re-claimed (another lease observed
    completion first, or the host is reclaimed between slices) loses at
    most one slice of counters instead of its whole segment.  Best
    effort: counters are reporting, not correctness — a persistent
    storage fault here is logged and dropped, never raised."""
    engine = st.engine
    snap = _snapshot(engine)
    snap["timing"] = engine.scheduler.timing(**st.marks)
    snap["n_requests"] = st.acked
    snap["worker_id"] = st.worker_id
    lease_key = f"{st.out}/leases/{wid_safe}.json"
    try:
        _with_retries(
            lambda: ctx.store.put_json(lease_key, snap),
            key=lease_key, clock=ctx.clock,
        )
    except Exception:  # noqa: BLE001
        ctx.log("segment-counter persist failed (dropped)")


def _revocation_drain(ctx: WorkerContext, st: _LeaseState, wid_safe: str) -> None:
    """Graceful spot-revocation drain, inside the notice window: stop
    admitting, checkpoint every active generation (emitted tokens +
    sampling position durably recorded, resident KV — sub-page tail
    included — published through the prefix store), roll active rows
    back, flush prefix-store publications (hydration is what makes the
    replacement cheap), make every in-flight request message visible NOW
    (receive counts intact: churn must still march poison requests toward
    the DLQ), and persist this segment's counters — the replacement's
    summary cannot include them.

    Ordering is the whole contract: checkpoint records and page
    publications land in the object store BEFORE the requeue makes the
    messages claimable (durable-before-ack), so a resuming worker either
    sees a complete checkpoint or none at all — never a half one."""
    engine = st.engine
    engine.stats.revocation_notices += 1
    for row, slot in enumerate(engine.slots):
        if slot.req is not None:
            if st.ckpt_prefix is not None:
                try:
                    ckpt = engine.checkpoint_slot(row)
                    if ckpt is not None:
                        key = f"{st.ckpt_prefix}{_uid_safe(ckpt['uid'])}.json"
                        _with_retries(
                            lambda k=key, c=ckpt: ctx.store.put_json(
                                k, _seal_checkpoint(c)
                            ),
                            key=key, clock=ctx.clock,
                        )
                except Exception:  # noqa: BLE001 - checkpointing is an
                    # optimization: a storage fault here must never block
                    # the drain (the request full-replays instead)
                    ctx.log(
                        f"checkpoint for {slot.req.uid!r} failed; "
                        "request will replay from token zero"
                    )
            engine.scheduler.preempt(row)
    # durable copies of everything local live in st.inflight; dropping
    # the local queue loses no requests
    engine.scheduler.pending.clear()
    engine.cache_mgr.flush_store()
    requeued = 0
    for uid, m in st.inflight.items():
        if _with_retries(
            lambda m=m: st.rq.change_visibility(m, 0.0),
            key=f"drain/{uid}", clock=ctx.clock,
        ):
            requeued += 1
    engine.stats.drain_requeued_requests += requeued
    _persist_segment(ctx, st, wid_safe)
    _report_progress(ctx, st)
    _LEASE_STATES.pop(st.key, None)
    st.rq.close()
    if st.dq is not None:
        st.dq.close()
    ctx.log(
        f"revocation drain: requeued {requeued} in-flight requests, "
        f"flushed prefix publications, persisted segment counters"
    )


def _serve_stream(job: Dict, ctx: WorkerContext) -> Dict:
    """Stream request messages from a DurableQueue through the scheduler.

    Loop shape: top up a bounded admission backlog from the queue, run
    one engine tick, ack whatever finished, extend in-flight leases on
    the heartbeat cadence.  Exits when ``expected_requests`` acks have
    landed, or after ``stream_idle_polls`` consecutive iterations with
    no messages and no active work; with ``stream_slice_ticks`` > 0 it
    additionally yields the lease every that-many engine ticks (elastic
    mode — see the module docstring).
    """
    out = job.get("output_prefix", "serve/stream0")
    role = str(job.get("worker_role", "unified"))
    if role == "prefill" and not job.get("decode_queue"):
        raise ValueError(
            "worker_role='prefill' requires a 'decode_queue' in the job "
            "(where else would the sealed handoff records go?)"
        )
    # a prefill lease's completion records are its handoff markers (one
    # sealed record per prompt handed off, written before the request
    # ack); termination, uid dedup and resume seeding all read this prefix
    req_prefix = f"{out}/handoffs/" if role == "prefill" else f"{out}/requests/"
    slice_ticks = int(job.get("stream_slice_ticks", 0))
    wid_safe = ctx.worker_id.replace("/", "~")
    # elastic leases write per-worker summaries (many workers share one
    # output prefix); the legacy single-holder lease keeps RESULTS.json
    results_key = (
        f"{out}/RESULTS-{wid_safe}.json" if slice_ticks else f"{out}/RESULTS.json"
    )
    expected: Optional[int] = (
        int(job["expected_requests"]) if job.get("expected_requests") else None
    )
    key = (ctx.worker_id, str(job["request_queue"]), out)
    st = _LEASE_STATES.get(key)

    if ctx.revoked():
        if st is not None:
            # our notice arrived between slices: this claim is the drain
            _revocation_drain(ctx, st, wid_safe)
            raise LeaseYield("revocation notice: drained", retry_in=0.0)
        # nothing of ours to drain — refuse new work for the remainder
        # of the notice window (the fleet reclaims the machine shortly)
        raise NotReady("revocation notice: refusing new lease", retry_in=0.0)

    def _served_uids() -> set:
        # lease memory is O(inflight), not O(total served): completions
        # live in the object store (one record per request, written
        # before the ack) and only the uid SET is held in RAM.  Records
        # persisted by a previous (crashed/revoked) holder seed the set,
        # so ``expected_requests`` still terminates and the final
        # summary includes them.
        return {
            info.key[len(req_prefix):-len(".json")]
            for info in _with_retries(
                lambda: ctx.store.list(req_prefix),
                key=req_prefix, clock=ctx.clock,
            )
            if info.key.endswith(".json")
        }

    if st is None:
        served = _served_uids()
        if slice_ticks and expected is not None and len(served) >= expected:
            # spare permit claimed after the fleet already finished:
            # ack it without building an engine
            summary = {"n_requests": 0, "noop": True}
            if not _with_retries(
                lambda: ctx.store.exists(results_key),
                key=results_key, clock=ctx.clock,
            ):
                _with_retries(
                    lambda: ctx.store.put_json(results_key, summary),
                    key=results_key, clock=ctx.clock,
                )
            return summary
        engine = _build_engine(job, ctx)
        rq = DurableQueue(
            str(job["request_queue"]),
            default_visibility=float(job.get("request_visibility", 120.0)),
            # the DLQ threshold is a consumer-side setting: every lease on
            # this queue must claim with the same one or they disagree on
            # when a poison request is dead
            max_receive_count=int(job.get("request_max_receive_count", 3)),
            clock=ctx.clock,
        )
        st = _LeaseState(key, ctx, out, req_prefix, results_key, engine, rq)
        st.served = served
        st.role = role
        if role == "prefill":
            # handoffs ride the same durable-queue machinery as requests
            st.dq = DurableQueue(
                str(job["decode_queue"]),
                default_visibility=float(job.get("request_visibility", 120.0)),
                max_receive_count=int(job.get("request_max_receive_count", 3)),
                clock=ctx.clock,
            )
        # prefill leases never resume from generation checkpoints: their
        # rows finish with zero output (nothing to preserve)
        if job.get("generation_checkpoints", True) and role != "prefill":
            st.ckpt_prefix = f"{out}/checkpoints/"
        if served:
            # cold build joining a run with prior progress: a resume.
            # (Hard-killed segments lose at most their LAST slice of
            # counters — every slice yield persists the cumulative
            # snapshot under leases/, and drains persist theirs too.)
            engine.stats.lease_resumes += 1
        _LEASE_STATES[key] = st
    else:
        # warm resume by the same worker: re-point the engine's heartbeat
        # at THIS claim's context (lease extension needs the new receipt)
        st.ctx = ctx
        st.engine.heartbeat = lambda: ctx.heartbeat()
        st.last_ext = ctx.clock.now()

    engine, rq = st.engine, st.rq
    inflight, served = st.inflight, st.served
    # generous idle default (~2.5 s of queue quiet at the default poll):
    # the lease ending strands later arrivals with no consumer, so err
    # well past ordinary arrival gaps; tune down for batch-like use
    idle_limit = int(job.get("stream_idle_polls", 50))
    poll = float(job.get("stream_poll_seconds", 0.05))
    vis = rq.default_visibility
    iters = 0
    try:
        while True:
            if ctx.revoked():
                # notice arrived mid-slice (a beat-triggered fault)
                _revocation_drain(ctx, st, wid_safe)
                raise LeaseYield("revocation notice: drained", retry_in=0.0)
            # keep a pending backlog one batch deep so freed rows refill
            # from local memory instead of waiting on a queue round-trip
            backlog = len(engine.pending) + sum(
                1 for s in engine.slots if s.req is not None
            )
            want = 2 * engine.max_batch - backlog
            claimed = (
                _with_retries(
                    lambda: rq.receive_batch(want),
                    key=str(job["request_queue"]), clock=ctx.clock,
                )
                if want > 0 else []
            )
            for m in claimed:
                req = _request_from(m.body, job, fallback_uid=m.id)
                # resolve client uid collisions FIRST: a DIFFERENT prompt
                # under a known uid is its own request, disambiguated by
                # message id — which is stable across redeliveries, so
                # the dedup below applies to the renamed uid too
                known_prompt = None
                if req.uid in inflight:
                    known_prompt = [
                        int(t) for t in inflight[req.uid].body["prompt"]
                    ]
                elif req.uid in served:
                    rec_key = f"{req_prefix}{req.uid}.json"
                    known_prompt = _with_retries(
                        lambda: ctx.store.get_json(rec_key),
                        key=rec_key, clock=ctx.clock,
                    )["prompt"]
                if known_prompt is not None and known_prompt != req.prompt:
                    ctx.log(f"uid collision on {req.uid!r}: distinct prompt, "
                            f"serving as {req.uid}~{m.id[:8]}")
                    req.uid = f"{req.uid}~{m.id[:8]}"
                if req.uid in served:
                    # redelivery of a request already served here (its
                    # earlier delete hit a stale receipt): ack this copy
                    _with_retries(
                        lambda m=m: rq.delete(m),
                        key=f"ack/{req.uid}", clock=ctx.clock,
                    )
                    continue
                if req.uid in inflight:
                    # duplicate delivery while the first copy is still
                    # being served: the receipt has rotated, so keep the
                    # FRESH handle or the eventual ack becomes a no-op
                    # and the served request marches to the DLQ
                    inflight[req.uid] = m
                    continue
                if m.receive_count > 1:
                    # a request delivered before (requeued by a drain or
                    # resurfaced by a dead worker's visibility timeout)
                    # resuming on this lease
                    engine.stats.requests_resumed += 1
                    if st.ckpt_prefix is not None and _try_resume(
                        engine, ctx, st.ckpt_prefix, req
                    ) is not None:
                        # work-preserving resume: admitted from its
                        # generation checkpoint with the already-emitted
                        # tokens pre-seeded — only the frontier token and
                        # the remaining budget get decoded
                        inflight[req.uid] = m
                        continue
                if role == "decode":
                    # decode-queue messages ARE sealed handoff records.  One
                    # that fails its seal check is never admitted: it stays
                    # in flight unacked, so the visibility timeout resurfaces
                    # it and receive counting marches it to the DLQ
                    rec = dict(m.body)
                    if not _handoff_valid(rec):
                        engine.stats.handoff_seal_rejects += 1
                        continue
                    # carry a uid-collision rename through (the seal was
                    # verified over the original body above)
                    rec["uid"] = req.uid
                    inflight[req.uid] = m
                    engine.submit_handoff(rec)
                    continue
                inflight[req.uid] = m
                engine.submit([req])

            progressed = bool(claimed)
            if engine.pending or engine.scheduler.has_active():
                engine.step()  # heartbeats once per dispatch
                progressed = True
            # drain (not slice) the finished list: a long-lived lease
            # must not retain every served Request object forever
            for r in engine.scheduler.drain_finished():
                if role == "prefill":
                    # finished here means "prompt ingested and published":
                    # seal the handoff, pin its chain, enqueue it, persist
                    # the marker, THEN ack (see _publish_handoff)
                    _publish_handoff(ctx, st, r, inflight.pop(r.uid, None))
                    served.add(r.uid)
                    continue
                rec = {
                    # a checkpoint-resumed request ran with an extended
                    # prompt; the record always carries the ORIGINAL one
                    # (uid-collision checks and parity consumers compare
                    # against what the client actually sent)
                    "prompt": r.prompt[: len(r.prompt) - r.resume_base],
                    "completion": r.output,
                    "done_at": ctx.clock.now(),
                }
                m = inflight.pop(r.uid, None)
                if m is not None:
                    # durable-before-ack: the completion must be in the
                    # object store BEFORE its message is deleted, or a
                    # worker crash between ack and the lease-end summary
                    # silently loses served requests (the visibility
                    # timeout cannot resurface a deleted message).  Both
                    # sides retry through transient store/queue faults
                    rec_key = f"{req_prefix}{r.uid}.json"
                    _with_retries(
                        lambda: ctx.store.put_json(rec_key, rec),
                        key=rec_key, clock=ctx.clock,
                    )
                    _with_retries(  # per-request ack: at-least-once upheld
                        lambda: rq.delete(m), key=rec_key, clock=ctx.clock,
                    )
                    st.acked += 1
                served.add(r.uid)
            # a preempted-and-requeued request is still in ``inflight``:
            # its lease (and every other in-flight lease) is extended here,
            # so durable requeue happens only if THIS worker dies
            now = ctx.clock.now()
            if inflight and now - st.last_ext > vis / 2:
                for uid, m in inflight.items():
                    _with_retries(
                        lambda m=m: rq.change_visibility(m, vis),
                        key=f"extend/{uid}", clock=ctx.clock,
                    )
                st.last_ext = now
            # bound per-lease memory: keep only a recent latency window
            # (the reported percentiles describe it) — Request objects
            # are already drained above
            engine.scheduler.trim_samples(10_000)
            ctx.heartbeat()
            iters += 1
            if expected is not None and len(served) >= expected:
                break
            if progressed:
                st.idle = 0
            else:
                st.idle += 1
                if st.idle >= idle_limit:
                    break
                ctx.clock.sleep(poll)
            if slice_ticks and iters >= slice_ticks:
                engine.stats.lease_slices += 1
                # counters survive even if this permit is never re-claimed
                # (consumers dedup per worker: a final RESULTS- summary
                # supersedes this slice-cumulative record)
                _persist_segment(ctx, st, wid_safe)
                _report_progress(ctx, st)
                raise LeaseYield(
                    f"slice budget spent ({slice_ticks} engine ticks)",
                    retry_in=0.0,
                )
    except LeaseYield:
        raise  # warm state stays cached for the next claim
    except BaseException:
        # crash/preemption: drop the warm state.  Unacked requests
        # resurface via their visibility timeouts — the at-least-once
        # story — and in-memory segment counters are lost (a crash is a
        # crash).  Publications are flushed so survivors can still
        # hydrate this segment's pages.
        _LEASE_STATES.pop(key, None)
        try:
            engine.cache_mgr.flush_store()
        finally:
            rq.close()
            if st.dq is not None:
                st.dq.close()
        raise
    # completed: this holder saw the run through to its exit condition
    _LEASE_STATES.pop(key, None)
    _report_progress(ctx, st)
    rq.close()
    if st.dq is not None:
        st.dq.close()
    # lease end is a drain seam: prefix-store publishes must be durable
    # before the lease's counters are reported
    engine.cache_mgr.flush_store()
    # lease-end aggregate, assembled FROM the per-request records (the
    # single source of truth); only this one-shot summary materializes
    # every completion in memory at once
    results = {
        info.key[len(req_prefix):-len(".json")]: _with_retries(
            lambda k=info.key: ctx.store.get_json(k),
            key=info.key, clock=ctx.clock,
        )
        for info in _with_retries(
            lambda: ctx.store.list(req_prefix),
            key=req_prefix, clock=ctx.clock,
        )
        if info.key.endswith(".json")
    }
    snap = _snapshot(engine)
    # window the lease's percentiles by the recorded absolute marks; only
    # samples still retained after trims are summarizable, and the count
    # of trimmed-away samples is reported alongside so a bounded window
    # is visible, not silent
    snap["timing"] = engine.scheduler.timing(**st.marks)
    snap["timing_samples_trimmed"] = (
        engine.scheduler.waits_dropped + engine.scheduler.ttfts_dropped
    )
    _with_retries(
        lambda: ctx.store.put_json(results_key, {"requests": results, **snap}),
        key=results_key, clock=ctx.clock,
    )
    return {"n_requests": st.acked, **snap}
