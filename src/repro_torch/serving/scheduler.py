"""RequestScheduler — the serving tier's admission and batching layer.

A copy of the reference package's framework-free ``serving/scheduler.py``
(the port keeps its own), restricted to what the port's engine runs:
the pending queue, the slot pool with continuous batching, the
``refill_policy`` and ``prefill_token_budget`` knobs, the preemption /
requeue policy the allocator escalates to under pool pressure, and
per-request latency accounting in engine ticks, and the streaming
lease's surface: checkpoint-resume admission (:meth:`submit_resume`),
:meth:`drain_finished`, :meth:`trim_samples` and windowed
:meth:`timing` over :meth:`sample_marks`, and the disaggregated roles:
``role="decode"`` admits only sealed handoff records
(:meth:`submit_handoff`), ``role="prefill"`` refuses them.

- ``refill_policy``: ``"continuous"`` (default) admits into every freed
  row at each tick; ``"drain"`` only admits when *all* slots are empty
  (the serve-a-batch-then-drain baseline).
- ``prefill_token_budget``: cap on prompt tokens ingested per tick.
  ``None`` (default) drains every pending prompt chunk before decoding;
  a finite budget interleaves chunked prefill with decode.

The scheduler never touches device state.  Admission calls into the
:class:`~repro_torch.serving.cache_manager.KVCacheManager` (row reset +
prefix stitching); the cache manager calls back into
:meth:`preempt_for` when the page pool is exhausted — preemption policy
(youngest-first, requeue-at-front, counter rollback) lives HERE, page
release lives there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.serving.types import EngineStats, Request, Slot, percentiles


class RequestScheduler:
    # sentinel returned by preempt_for: no victim younger than the
    # requester exists — the requester itself must yield, which the
    # allocator does at a clean seam AFTER its allocation loop unwinds
    # (see preempt_for's docstring)
    YIELD = -1

    def __init__(
        self,
        max_batch: int,
        stats: EngineStats,
        *,
        refill_policy: str = "continuous",
        prefill_token_budget: Optional[int] = None,
        role: str = "unified",
    ):
        if refill_policy not in ("continuous", "drain"):
            raise ValueError(
                f"refill_policy must be continuous|drain, got {refill_policy!r}"
            )
        if prefill_token_budget is not None and prefill_token_budget <= 0:
            raise ValueError("prefill_token_budget must be positive or None")
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"role must be unified|prefill|decode, got {role!r}"
            )
        self.max_batch = max_batch
        self.stats = stats
        self.refill_policy = refill_policy
        self.prefill_token_budget = prefill_token_budget
        # disaggregated-serving role: a "decode" scheduler admits ONLY
        # sealed handoff records (fresh prefill work is refused at submit);
        # a "prefill" scheduler refuses handoffs and never runs a decode
        # tick (the engine finishes each prompt at ingest completion)
        self.role = role
        self.slots = [Slot() for _ in range(max_batch)]
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self.tick = 0  # engine steps begun; the unit of all latency stats
        self._admit_seq = 0
        self._n_submitted = 0
        # latency samples in ticks (appended as events happen; consumers
        # scope a measurement window with sample_marks()/timing(); None =
        # sample voided by preemption rollback).  The lists are bounded by
        # trim_samples; the *_dropped counters record how many samples
        # fell off the front, so a mark recorded with sample_marks() stays
        # an absolute sample id across trims
        self.queue_waits: List[Optional[int]] = []
        self.ttfts: List[Optional[int]] = []
        self.waits_dropped = 0
        self.ttfts_dropped = 0
        # wired by the engine to KVCacheManager: admission stitches
        # prefixes, finish/preempt release pages
        self.cache = None

    # ------------------------------------------------------------- intake
    def submit(self, reqs: List[Request]) -> None:
        if self.role == "decode":
            fresh = [r.uid for r in reqs if not r.handoff]
            if fresh:
                raise RuntimeError(
                    "decode-role scheduler refuses fresh prefill work "
                    f"(uids {fresh}); route it through a prefill worker "
                    "and submit the sealed handoff via submit_handoff"
                )
        for r in reqs:
            # per-request sampling stream: submit-order, scheduling-
            # independent, so any admission policy draws identical samples
            r.sample_stream = self._n_submitted
            self._n_submitted += 1
            if r.submit_tick < 0:
                r.submit_tick = self.tick
        self.pending.extend(reqs)

    def submit_handoff(self, req: Request) -> None:
        """Queue a request admitted from a prefill worker's sealed handoff
        record.  Like :meth:`submit_resume` the sampling stream is NOT
        reassigned (the decode must draw on the stream the original
        submission drew on the prefill worker) and the local counter
        advances past it.  Unlike a resume it queues at the BACK like
        fresh work: handoffs arrive in decode-queue order."""
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-role scheduler refuses handoff admissions "
                f"(uid {req.uid!r}); handoffs are decode-side work"
            )
        req.handoff = True
        self._n_submitted = max(self._n_submitted, req.sample_stream + 1)
        if req.submit_tick < 0:
            req.submit_tick = self.tick
        self.pending.append(req)

    def submit_resume(self, req: Request) -> None:
        """Queue a checkpoint-resumed request WITHOUT reassigning its
        sampling stream: byte-identical continuation requires the stream
        the original submission drew, not this worker's next id.  The
        local stream counter still advances so later fresh submissions
        on this scheduler cannot collide with the resumed stream."""
        self._n_submitted = max(self._n_submitted, req.sample_stream + 1)
        if req.submit_tick < 0:
            req.submit_tick = self.tick
        self.pending.insert(0, req)

    # ------------------------------------------------------------ admission
    def begin_tick(self) -> None:
        """Advance the tick clock and run the admission policy."""
        self.tick += 1
        self.stats.ticks += 1
        self.refill()

    def refill(self) -> None:
        if self.refill_policy == "drain" and any(
            s.req is not None for s in self.slots
        ):
            return
        for row, slot in enumerate(self.slots):
            if slot.req is None and self.pending:
                # admission control: a request admitted into a pool with
                # neither a free nor an evictable page can only yield
                # straight back to the queue on its first allocation (as
                # the youngest slot it has nobody to preempt) — pure
                # admit/rollback churn; hold the queue until capacity
                # exists — active slots finish and reopen the gate
                if not self.cache.can_admit():
                    break
                self._admit(row, self.pending.pop(0))

    def _admit(self, row: int, req: Request) -> None:
        slot = self.slots[row]
        slot.req = req
        slot.pos = 0
        slot.seq = self._admit_seq
        self._admit_seq += 1
        slot.remaining_prompt = list(req.prompt)
        slot.hit_tokens = 0
        slot.hit_tokens_partial = 0
        slot.skipped_tokens = 0
        req.admit_tick = self.tick
        self.stats.admissions += 1
        slot.wait_idx = len(self.queue_waits)
        slot.ttft_idx = -1
        self.queue_waits.append(self.tick - req.submit_tick)
        # row identity comes from ENUMERATION — Slot is a value-comparing
        # dataclass, so slots.index(slot) can return a different-but-equal
        # slot and zero the wrong row
        self.cache.reset_row(row)
        self.cache.stitch_prefix(row, slot)

    def has_active(self) -> bool:
        return any(s.req is not None for s in self.slots)

    # ----------------------------------------------------------- lifecycle
    def on_token(self, row: int) -> None:
        """Called by the executor for every accepted token."""
        slot = self.slots[row]
        req = slot.req
        if req.first_token_tick < 0:
            req.first_token_tick = self.tick
            slot.ttft_idx = len(self.ttfts)
            self.ttfts.append(self.tick - req.submit_tick)

    def finish(self, row: int) -> None:
        """Retire a completed request and free its row for refill."""
        slot = self.slots[row]
        slot.req.done = True
        slot.req.done_tick = self.tick
        self.finished.append(slot.req)
        slot.req = None
        slot.remaining_prompt = []
        self.cache.release_slot(row)

    def drain_finished(self) -> List[Request]:
        """Hand over (and forget) the finished requests accumulated so
        far.  Long-lived consumers (the queue-streaming lease) use this
        instead of reading ``finished`` so served requests do not pile
        up in memory for the lease's lifetime."""
        done, self.finished = self.finished, []
        return done

    # ----------------------------------------------------------- preemption
    def preempt_for(self, row: int) -> Optional[int]:
        """Pool-pressure escalation point (called by the cache manager's
        allocator): preempt the youngest active slot *other than* — and
        strictly younger than — the requesting ``row``, and return its
        row.  The requester is never selected as victim here: preempting
        it mid-allocation would release the very pages being assembled
        and hand its own row back to the allocator (the old bug).  When
        the requester is itself the youngest active slot, age priority
        says the requester is the one that must go — but that yield is
        NOT performed here: ``YIELD`` is returned and the cache manager
        requeues the row (via :meth:`preempt`) only after its allocation
        loop has fully unwound.  Preempting an *older* slot instead
        would invert age priority and can live-lock — two slots
        preempting each other forever with neither finishing.  Returns
        None — allocator raises — only when no *other* slot is active (a
        lone request that cannot fit the pool must fail loudly, not
        live-lock)."""
        me = self.slots[row].seq
        victim = None
        others = False
        for i, s in enumerate(self.slots):
            if i == row or s.req is None:
                continue
            others = True
            if s.seq > me and (victim is None or s.seq > self.slots[victim].seq):
                victim = i
        if victim is None:
            return self.YIELD if others else None
        self.preempt(victim)
        return victim

    def preempt(self, row: int) -> None:
        """Release the slot and requeue its request at the queue front.
        Any generated tokens are discarded — the per-request sampling
        stream replays them identically on rerun.

        Delivery counters are rolled back to what the rerun will re-earn
        (the discarded work lands in ``tokens_discarded`` instead), so
        ``tokens_emitted`` always equals tokens actually delivered and
        the paged-vs-dense parity gates stay exact across preemptions.
        The request keeps its ``submit_tick`` (its latency clock does
        not reset) but re-earns admission and first-token times."""
        slot = self.slots[row]
        req = slot.req
        self.cache.release_slot(row)
        # checkpoint-resumed requests keep their pre-seeded output: those
        # tokens live in the extended prompt and were never emitted here
        emitted = len(req.output) - req.resume_base
        ingested = min(slot.pos, len(req.prompt)) - slot.skipped_tokens
        st = self.stats
        st.tokens_emitted -= emitted
        st.prompt_tokens_ingested -= ingested
        st.tokens_discarded += emitted + ingested
        # the decode-work subset separately: this is what a generation
        # checkpoint saves a resume from re-deriving (minus the frontier
        # token), so recovery efficiency = recovered / discarded
        st.decode_tokens_discarded += emitted
        st.prefix_hit_tokens -= slot.hit_tokens
        st.prefix_hit_tokens_partial -= slot.hit_tokens_partial
        st.prompt_tokens_skipped -= slot.skipped_tokens
        del req.output[req.resume_base:]
        req.done = False
        req.admit_tick = -1
        req.first_token_tick = -1
        # void the aborted attempt's latency samples (in place: windowing
        # by list index must stay stable); the rerun records fresh ones
        if slot.wait_idx >= 0:
            self.queue_waits[slot.wait_idx] = None
        if slot.ttft_idx >= 0:
            self.ttfts[slot.ttft_idx] = None
        slot.req = None
        slot.pos = 0
        slot.remaining_prompt = []
        slot.hit_tokens = 0
        slot.hit_tokens_partial = 0
        slot.skipped_tokens = 0
        slot.wait_idx = -1
        slot.ttft_idx = -1
        self.pending.insert(0, req)
        st.preemptions += 1

    # ------------------------------------------------------------- reporting
    def trim_samples(self, max_samples: int) -> None:
        """Bound the latency-sample lists to their ``max_samples`` most
        recent entries (long-lived streaming leases call this per loop;
        their percentiles then describe the recent window).  Slots'
        recorded sample indices are remapped so preemption rollback
        keeps voiding the right entries; an index that falls off the
        front is simply no longer voidable.  The cumulative
        ``waits_dropped``/``ttfts_dropped`` offsets advance so marks
        recorded with :meth:`sample_marks` before the trim keep
        addressing the same samples through :meth:`timing`."""
        for name, dropped in (("queue_waits", "waits_dropped"),
                              ("ttfts", "ttfts_dropped")):
            lst = getattr(self, name)
            drop = len(lst) - max_samples
            if drop <= 0:
                continue
            setattr(self, name, lst[drop:])
            setattr(self, dropped, getattr(self, dropped) + drop)
            attr = "wait_idx" if name == "queue_waits" else "ttft_idx"
            for slot in self.slots:
                idx = getattr(slot, attr)
                if idx >= 0:
                    setattr(slot, attr, idx - drop if idx >= drop else -1)

    def sample_marks(self) -> Dict[str, int]:
        """Absolute sample ids marking 'now' in each latency list.  Pass
        them to :meth:`timing` to scope a measurement window; unlike raw
        list lengths they survive :meth:`trim_samples` (the ids count
        every sample ever recorded, including trimmed ones)."""
        return {
            "waits_since": self.waits_dropped + len(self.queue_waits),
            "ttfts_since": self.ttfts_dropped + len(self.ttfts),
        }

    def timing(
        self, waits_since: int = 0, ttfts_since: int = 0
    ) -> Dict[str, Dict[str, float]]:
        """Queue-wait and TTFT percentile summaries (ticks).  The
        arguments are *absolute* sample ids (0 = everything ever
        recorded) from :meth:`sample_marks`: samples a trim dropped are
        no longer summarizable, but a pre-trim mark keeps addressing the
        same window instead of silently sliding forward."""
        return {
            "queue_wait_ticks": percentiles(
                self.queue_waits[max(0, waits_since - self.waits_dropped):]
            ),
            "ttft_ticks": percentiles(
                self.ttfts[max(0, ttfts_since - self.ttfts_dropped):]
            ),
        }
