"""Shared serving-layer types: the request/slot dataclasses and the
engine-wide counter block.

A copy of the reference package's ``serving/types.py`` (framework-free;
the port keeps its own).  The serving tier is three layers with explicit
seams: :class:`repro_torch.serving.scheduler.RequestScheduler`
(admission, continuous batching, preemption),
:class:`repro_torch.serving.cache_manager.KVCacheManager` (paged
refcounted allocator, copy-on-write, radix prefix cache) and
:class:`repro_torch.serving.engine.ServeEngine` (device dispatch and
sampling).  :class:`EngineStats` is the one counter block all three
write into; its fields and :meth:`EngineStats.snapshot` keys are the
reference's, so the two engines' counters compare key for key.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional


@dataclass
class Request:
    uid: str
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 = greedy
    # emitting this token id finishes the request (it is kept in the
    # output); None disables.  Checked on device via the fused done mask.
    stop_token: Optional[int] = None
    # filled by the engine
    output: List[int] = field(default_factory=list)
    done: bool = False
    # per-request sampling stream id (assigned at submit; scheduling- and
    # slot-independent so fused and grouped modes draw identical samples)
    sample_stream: int = field(default=0, compare=False, repr=False)
    # checkpoint-resume bookkeeping: number of leading output tokens that
    # were pre-seeded from a generation checkpoint (they are ALSO the
    # tail of the extended prompt).  Preemption rollback keeps them (they
    # were never emitted on this worker), and the original prompt is
    # recoverable as prompt[:len(prompt) - resume_base]
    resume_base: int = field(default=0, compare=False, repr=False)
    # admitted from a sealed prefill->decode handoff record: admission
    # runs the demand-driven hydration path (fetch exactly the chained
    # pages a prefill worker published) and counts a fallback when the
    # store cannot cover the prompt.  Decode-role schedulers accept only
    # these (see RequestScheduler).
    handoff: bool = field(default=False, compare=False, repr=False)
    # scheduler timing, in engine ticks (compare-excluded: two requests
    # with identical content are interchangeable to the batch).  -1 =
    # not yet reached.  queue wait = admit - submit; time-to-first-token
    # = first_token - submit.  A preempted request keeps submit_tick (its
    # latency clock does not reset) but re-earns admit/first-token.
    submit_tick: int = field(default=-1, compare=False, repr=False)
    admit_tick: int = field(default=-1, compare=False, repr=False)
    first_token_tick: int = field(default=-1, compare=False, repr=False)
    done_tick: int = field(default=-1, compare=False, repr=False)


@dataclass
class Slot:
    """One continuous-batching row: the scheduler owns the pool of these."""

    req: Optional[Request] = None
    pos: int = 0  # next cache position to write
    remaining_prompt: List[int] = field(default_factory=list)
    # admission order (monotonic): preemption picks the youngest = max seq
    seq: int = -1
    # prefix-cache stitch accounting for THIS admission (rolled back if
    # the slot is preempted, so counters never double-count a rerun)
    hit_tokens: int = 0
    hit_tokens_partial: int = 0  # sub-page tokens reused via CoW stitch
    skipped_tokens: int = 0
    # indices of THIS admission's latency samples in the scheduler's
    # queue_waits/ttfts lists (-1 = none recorded): preemption voids the
    # aborted attempt's samples so reruns are not double-counted
    wait_idx: int = -1
    ttft_idx: int = -1


@dataclass
class EngineStats:
    """Engine-wide counters.  Owner key: [X] executor, [S] scheduler,
    [C] cache manager, [L] serving lease (the ``distributed-serve``
    payload, writing through the engine's stat aliases).  Fields
    prefixed ``_`` are internal working state and stay out of
    :meth:`snapshot`."""

    # [X] dispatch accounting
    steps_executed: int = 0  # decode dispatches (seed-compatible name)
    decode_dispatches: int = 0
    prefill_dispatches: int = 0
    dispatches: int = 0
    tokens_emitted: int = 0
    prompt_tokens_ingested: int = 0
    # [S] scheduling
    ticks: int = 0
    admissions: int = 0
    preemptions: int = 0
    tokens_discarded: int = 0  # preempted work (re-earned on rerun)
    # [C] paged pool
    pages_in_use: int = 0
    peak_pages: int = 0
    page_allocs: int = 0  # lifetime allocations (> n_pages => reuse)
    page_bytes: int = 0
    dense_cache_bytes: int = 0
    # [C] prefix sharing
    prefix_hit_tokens: int = 0  # prompt tokens found in the cache
    prompt_tokens_skipped: int = 0  # of those, never dispatched
    # sub-page reuse: tokens matched inside the first divergent page
    # (reused through a CoW copy of the partially-matched page) and the
    # number of such partial-page stitches performed
    prefix_hit_tokens_partial: int = 0
    cow_partial_stitches: int = 0
    pages_shared_peak: int = 0  # max pages with refcount > 1
    cow_copies: int = 0
    prefix_evictions: int = 0
    _shared_pages: int = 0  # pages with refcount > 1, kept O(1)
    # [C] cross-host prefix store
    prefix_store_pages_published: int = 0
    prefix_store_pages_hydrated: int = 0
    prefix_store_tokens_hydrated: int = 0
    # [X] speculative decoding.  One spec_dispatch is one fused verify
    # call (counted in decode_dispatches too — it replaces exactly one
    # decode dispatch); draft_dispatches are the draft model's own device
    # calls (catch-up prefill + per-draft-token decode), kept separate so
    # dispatches/token still describes the TARGET model.  Acceptance rate
    # is draft_tokens_accepted / draft_tokens_proposed; the headline
    # accepted_per_dispatch (accepted + bonus tokens per verify call) is
    # derived in snapshot().
    spec_dispatches: int = 0
    draft_dispatches: int = 0
    draft_tokens_proposed: int = 0
    draft_tokens_accepted: int = 0
    spec_tokens_emitted: int = 0  # all tokens emitted by verify dispatches
    # [L] elastic-lease robustness: spot-revocation notices observed by
    # this lease; in-flight request messages it made visible again while
    # draining; request messages it claimed that had been delivered
    # before (a requeued request resuming on a survivor); slice yields;
    # cold engine builds that found prior progress in the store (a lease
    # resuming after churn — prefix-store hydration is what makes these
    # cheap).
    revocation_notices: int = 0
    drain_requeued_requests: int = 0
    requests_resumed: int = 0
    lease_slices: int = 0
    lease_resumes: int = 0
    # [L] work-preserving recovery: generation checkpoints written at
    # drain (durable before the requeue ack); requests admitted FROM a
    # checkpoint on a surviving/replacement worker; already-emitted
    # tokens those resumes did not have to re-decode; checkpoints that
    # failed validation (missing/corrupt/hash-mismatch/prompt-mismatch)
    # and fell back down the ladder to prefix-hit or full replay.
    checkpoints_published: int = 0
    checkpoint_resumes: int = 0
    tokens_recovered: int = 0
    checkpoint_fallbacks: int = 0
    # [S] emitted tokens thrown away by preemption/drain (the subset of
    # tokens_discarded that was *decode* work — what checkpoints save)
    decode_tokens_discarded: int = 0
    # [C] store-path hardening: async publications that needed a retry
    # before landing, and fetched blobs rejected by the sha256 content
    # re-verification (counted as misses, never hydrated)
    publish_retries: int = 0
    prefix_store_hash_mismatches: int = 0
    # [C] hydration observability: store round-trips made to pull KV
    # pages into the pool (opportunistic + demand-driven) and the bytes
    # those fetches moved — handoff cost measured, not inferred.  The
    # publisher-side dedup counter mirrors AsyncPublisher.dedup_hits
    # (submits skipped because the identical page key was already
    # pending in its queue).
    hydration_fetch_ops: int = 0
    prefix_store_bytes_fetched: int = 0
    publish_dedup_hits: int = 0
    # [L]/[C] disaggregated prefill/decode: sealed handoff records a
    # prefill lease enqueued; handoff records a decode engine admitted
    # via the guaranteed-hit demand hydration path; admissions where the
    # store lied (chain pages missing/corrupt) and the slot fell back
    # down the recovery ladder to prefix-hit/full replay; handoff records
    # rejected at the seal/consistency check before admission.
    handoffs_published: int = 0
    handoffs_admitted: int = 0
    handoff_fallbacks: int = 0
    handoff_seal_rejects: int = 0
    # per-demand-hydration store fetch counts (deterministic round-trip
    # samples; summarized as the "hydration_ticks" percentile block)
    _hydration_ticks: List = field(default_factory=list)

    def snapshot(self) -> Dict[str, int]:
        """Every public counter as a plain dict (RESULTS.json payload),
        plus derived speculative-decoding rates."""
        snap = {
            f.name: getattr(self, f.name)
            for f in fields(self)
            if not f.name.startswith("_")
        }
        snap["accepted_per_dispatch"] = round(
            self.spec_tokens_emitted / self.spec_dispatches, 4
        ) if self.spec_dispatches else 0.0
        snap["hydration_ticks"] = percentiles(self._hydration_ticks)
        return snap


def percentiles(samples: List[Optional[int]]) -> Dict[str, float]:
    """Mean/p50/p90/max summary of tick-denominated latency samples.
    ``None`` entries (samples voided by preemption rollback — kept in
    place so windowing by list index stays stable) are excluded."""
    s = sorted(x for x in samples if x is not None)
    if not s:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0,
                "max": 0.0}
    n = len(s)
    return {
        "n": n,
        "mean": round(sum(s) / n, 3),
        # nearest-rank percentiles: index ceil(q*n) - 1
        "p50": float(s[(n - 1) // 2]),
        "p90": float(s[(9 * n - 1) // 10]),
        "p99": float(s[(99 * n - 1) // 100]),
        "max": float(s[-1]),
    }
