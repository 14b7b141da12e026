"""RequestScheduler — the serving tier's admission and batching layer.

A copy of the reference package's framework-free ``serving/scheduler.py``
(the port keeps its own), restricted to what the port's engine runs:
the pending queue, the slot pool with continuous batching, the
``refill_policy`` and ``prefill_token_budget`` knobs, the preemption /
requeue policy the allocator escalates to under pool pressure, and
per-request latency accounting in engine ticks.  Disaggregated roles,
handoff and checkpoint-resume admission and the streaming lease's
sample trimming are not ported (ROADMAP Queue 1).

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
    ):
        if refill_policy not in ("continuous", "drain"):
            raise ValueError(
                f"refill_policy must be continuous|drain, got {refill_policy!r}"
            )
        if prefill_token_budget is not None and prefill_token_budget <= 0:
            raise ValueError("prefill_token_budget must be positive or None")
        self.max_batch = max_batch
        self.stats = stats
        self.refill_policy = refill_policy
        self.prefill_token_budget = prefill_token_budget
        self.slots = [Slot() for _ in range(max_batch)]
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self.tick = 0  # engine steps begun; the unit of all latency stats
        self._admit_seq = 0
        self._n_submitted = 0
        # latency samples in ticks (appended as events happen; None =
        # sample voided by preemption rollback)
        self.queue_waits: List[Optional[int]] = []
        self.ttfts: List[Optional[int]] = []
        # wired by the engine to KVCacheManager: admission stitches
        # prefixes, finish/preempt release pages
        self.cache = None

    # ------------------------------------------------------------- intake
    def submit(self, reqs: List[Request]) -> None:
        for r in reqs:
            # per-request sampling stream: submit-order, scheduling-
            # independent, so any admission policy draws identical samples
            r.sample_stream = self._n_submitted
            self._n_submitted += 1
            if r.submit_tick < 0:
                r.submit_tick = self.tick
        self.pending.extend(reqs)

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
        # void the aborted attempt's latency samples (in place, so the
        # recorded indices stay valid); the rerun records fresh ones
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
    def timing(self) -> Dict[str, Dict[str, float]]:
        """Queue-wait and TTFT percentile summaries (ticks)."""
        return {
            "queue_wait_ticks": percentiles(self.queue_waits),
            "ttft_ticks": percentiles(self.ttfts),
        }
