"""Serving executor: the device-dispatch layer of the serving tier.

Counterpart of the reference package's ``serving/engine.py``, on the
dense (per-slot, the default) or the paged cache:
:class:`~repro_torch.serving.scheduler.RequestScheduler` admits requests
into freed rows (continuous batching), the
:class:`~repro_torch.serving.cache_manager.KVCacheManager` zeroes an
admitted row (dense) or backs the positions each dispatch will write
(paged: radix prefix cache, copy-on-write), and :class:`ServeEngine`
dispatches.  A tick runs fused chunked prefill (``prefill_chunk`` tokens
per row per dispatch), then one of:

- ``dispatch_mode="fused"`` (default): ONE decode dispatch for any mix
  of row positions, sampling and the done mask on the device;
- ``speculative="ngram"|"draft"``: a proposer
  (:mod:`repro_torch.serving.speculate`) guesses up to ``spec_k`` tokens
  a row and ONE verify dispatch (``Model.verify_chunk``, ``T = spec_k +
  1``) accepts the longest consistent run on the device; rejected
  positions are rewound (paged: trailing pages dropped);
- ``dispatch_mode="grouped"``: one decode dispatch per distinct row
  position, the reference's per-position baseline (prompts then ingest
  through the decode path, as in the reference).

Finished rows are parked (pages freed) before the next dispatch.  The
SSM family serves from the dense cache only, as in the reference.

Knob names, refusals and the :class:`EngineStats` counters are the
reference's; ``device`` (default ``cuda``) picks where the cache lives
and must hold the parameters (and the draft model's).  ``heartbeat`` is
called after every dispatch, at the reference's three sites (a serving
lease extends its queue lease and notices preemption there).  The
work-preserving recovery seam is the reference's too:
:meth:`ServeEngine.checkpoint_slot` records an active row's generation
(publishing its resident KV through the prefix store, when there is
one) and :meth:`ServeEngine.submit_resume` re-admits it for
token-for-token continuation, stitching the published generation.

With ``prefix_store`` (a
:class:`~repro_torch.serving.prefix_store.PrefixStore`; paged cache and
radix prefix cache required) completed prompts' pages are published to
the shared object store and cold admissions hydrate them.
``worker_role="prefill"`` ingests prompts only: each finishes at prompt
residency, its whole KV chain published, without sampling;
``worker_role="decode"`` admits only sealed handoff records
(:meth:`ServeEngine.submit_handoff`), whose chain it demand-hydrates.
Sampling streams are keyed by (seed, stream, step), so the decode
worker's frontier draw is the token a monolith draws.  Knob validation
is the reference's, message for message.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serving.cache_manager import KVCacheManager
from repro_torch.serving.sampling import make_decode_step, make_prefill_step, make_verify_step
from repro_torch.serving.scheduler import RequestScheduler
from repro_torch.serving.speculate import DraftProposer, NgramProposer
from repro_torch.serving.types import EngineStats, Request, Slot

__all__ = ["Request", "ServeEngine", "Slot"]


def _param_devices(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(_param_devices(v) for v in tree.values()))
    if isinstance(tree, list):
        return set().union(*(_param_devices(v) for v in tree))
    return {tree.device}


class ServeEngine:
    def __init__(
        self,
        model,
        params,
        *,
        max_batch: int = 4,
        max_len: int = 256,
        rng_seed: int = 0,
        prefill_chunk: int = 16,
        dispatch_mode: str = "fused",
        sample_on_device: bool = True,
        cache_mode: str = "dense",
        page_size: int = 16,
        total_pages: Optional[int] = None,
        prefix_cache: bool = True,
        prefix_match: str = "token",
        prefix_store=None,
        refill_policy: str = "continuous",
        prefill_token_budget: Optional[int] = None,
        worker_role: str = "unified",
        heartbeat: Callable[[], None] = lambda: None,
        speculative: str = "off",
        spec_k: int = 4,
        draft_model=None,
        draft_params=None,
        device=None,
    ):
        if dispatch_mode not in ("fused", "grouped"):
            raise ValueError(f"dispatch_mode must be fused|grouped, got {dispatch_mode!r}")
        if cache_mode not in ("dense", "paged"):
            raise ValueError(f"cache_mode must be dense|paged, got {cache_mode!r}")
        if cache_mode == "paged" and not model.supports_paged_cache:
            raise ValueError(
                "cache_mode='paged' unsupported for arch "
                f"{model.cfg.name!r} (no pageable KV cache)"
            )
        if prefix_store is not None and (cache_mode != "paged" or not prefix_cache):
            # the store publishes/hydrates through the radix cache over paged
            # pool pages, so without both it can never move a byte
            raise ValueError(
                "prefix_store requires cache_mode='paged' with "
                "prefix_cache=True; it would be silently inert here"
            )
        if worker_role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"worker_role must be unified|prefill|decode, got {worker_role!r}"
            )
        if worker_role != "unified" and prefix_store is None:
            # the handoff travels through the prefix store: without one the
            # roles would be silently inert
            raise ValueError(
                "worker_role='prefill'/'decode' requires a prefix_store "
                "(the KV handoff is storage-mediated); it would be "
                "silently inert here"
            )
        recurrent = model.cfg.family in ("ssm", "hybrid")
        if dispatch_mode == "grouped" and recurrent:
            # per-group re-dispatch re-advances recurrent state every extra
            # call per tick (KV writes are idempotent, recurrences are not)
            raise ValueError(
                "dispatch_mode='grouped' corrupts recurrent SSM/hybrid state; "
                f"use the fused engine for family {model.cfg.family!r}"
            )
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        held = _param_devices(params)
        if held != {self.device}:
            raise ValueError(f"params live on {sorted(map(str, held))}, the engine runs "
                             f"on {self.device}; move them first")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_chunk = int(prefill_chunk)
        self.dispatch_mode = dispatch_mode
        self.sample_on_device = sample_on_device
        self.cache_mode = cache_mode
        # called after every dispatch (a lease's liveness/extension hook)
        self.heartbeat = heartbeat

        # the layers share one counter block and are cross-wired at exactly
        # two points: admission (scheduler -> cache: reset + stitch) and
        # pool-pressure preemption (cache -> scheduler)
        self.stats = EngineStats()
        self.cache_mgr = KVCacheManager(
            model,
            max_batch=max_batch,
            max_len=max_len,
            stats=self.stats,
            device=self.device,
            cache_mode=cache_mode,
            page_size=page_size,
            total_pages=total_pages,
            prefix_cache=prefix_cache,
            prefix_match=prefix_match,
            prefix_store=prefix_store,
        )
        self.worker_role = worker_role
        self.scheduler = RequestScheduler(
            max_batch,
            self.stats,
            refill_policy=refill_policy,
            prefill_token_budget=prefill_token_budget,
            role=worker_role,
        )
        self.scheduler.cache = self.cache_mgr
        self.cache_mgr.preempt_for = self.scheduler.preempt_for
        # the yield seam: the allocator requeues the requesting row only
        # after its allocation loop unwound; skip when the slot was
        # already emptied by a direct preemption
        self.cache_mgr.preempt_row = (
            lambda row: self.scheduler.preempt(row)
            if self.scheduler.slots[row].req is not None else None
        )

        self._rng_seed = rng_seed
        self._decode = make_decode_step(model, rng_seed, sample_on_device)
        self._use_prefill = (
            dispatch_mode == "fused"
            and self.prefill_chunk > 0
            and model.supports_fused_prefill
            and not self.cache_mgr.cache_is_rolling()
        )
        self._prefill = (
            make_prefill_step(model, rng_seed, sample_on_device)
            if self._use_prefill else None
        )
        if worker_role == "prefill" and not self._use_prefill:
            # a prefill-role worker never runs a decode tick, so prompts
            # must ingest through the chunked-prefill path
            raise ValueError(
                "worker_role='prefill' requires the fused chunked-prefill "
                "path (dispatch_mode='fused', prefill_chunk > 0, a "
                "prefill-capable non-rolling arch)"
            )
        if worker_role == "prefill" and speculative != "off":
            raise ValueError(
                "speculative decoding never runs on a prefill-role worker "
                "(it has no decode ticks); it would be silently inert here"
            )
        self.speculative = speculative
        self.spec_k = int(spec_k)
        self.proposer = None
        self._verify = None
        if speculative not in ("off", "ngram", "draft"):
            raise ValueError(f"speculative must be off|ngram|draft, got {speculative!r}")
        if speculative == "off" and (draft_model is not None or draft_params is not None):
            raise ValueError(
                "draft_model/draft_params require speculative='draft'; they "
                "would be silently inert here"
            )
        if speculative != "off":
            self._init_speculative(recurrent, draft_model, draft_params, page_size)
        if prefill_token_budget is not None:
            # a finite budget holds rows mid-prefill across decode ticks: a
            # recurrence would be advanced by the decode dispatch it sits out
            if recurrent:
                raise ValueError(
                    "prefill_token_budget is unsupported for recurrent "
                    f"(family {model.cfg.family!r}) models: a mid-prefill "
                    "row's recurrence would be advanced by the decode "
                    "dispatch it sits out"
                )
            if not self._use_prefill:
                raise ValueError(
                    "prefill_token_budget requires the fused prefill path "
                    "(dispatch_mode='fused', prefill_chunk > 0, fused-"
                    "prefill-capable arch); it would be silently inert here"
                )

    def _init_speculative(self, recurrent: bool, draft_model, draft_params,
                          page_size: int) -> None:
        """The reference's speculative knob checks, in its order, then the
        verify dispatch and the proposer."""
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if not self.sample_on_device:
            raise ValueError(
                "speculative decoding verifies and accepts on device; "
                "sample_on_device=False would make the verify dispatch "
                "round-trip (B, k+1, vocab) logits — unsupported"
            )
        if recurrent:
            # KV rollback drops pages past the frontier; a recurrent state
            # advanced by rejected tokens cannot be rewound
            raise ValueError(
                "speculative decoding cannot roll back recurrent "
                f"(family {self.model.cfg.family!r}) state; rejected draft "
                "tokens would corrupt the recurrence"
            )
        if not self._use_prefill:
            raise ValueError(
                "speculative decoding verifies k+1 positions through the "
                "fused chunk-extend path (dispatch_mode='fused', "
                "prefill_chunk > 0, fused-prefill-capable arch, "
                "non-rolling cache); it cannot run here"
            )
        self._verify = make_verify_step(self.model, self._rng_seed)
        if self.speculative == "ngram":
            self.proposer = NgramProposer()
            return
        if draft_model is None or draft_params is None:
            raise ValueError("speculative='draft' needs draft_model and draft_params")
        held = _param_devices(draft_params)
        if held != {self.device}:
            raise ValueError(f"draft_params live on {sorted(map(str, held))}, the engine "
                             f"runs on {self.device}; move them first")
        self.proposer = DraftProposer(
            draft_model, draft_params, max_batch=self.max_batch, max_len=self.max_len,
            spec_k=self.spec_k, device=self.device, page_size=page_size, stats=self.stats,
        )

    # ---------------------------------------------- layer-delegation surface
    @property
    def cache(self):
        return self.cache_mgr.cache

    @property
    def prefix(self):
        return self.cache_mgr.prefix

    @property
    def pending(self) -> List[Request]:
        return self.scheduler.pending

    @property
    def finished(self) -> List[Request]:
        return self.scheduler.finished

    @property
    def slots(self) -> List[Slot]:
        return self.scheduler.slots

    @property
    def peak_cache_bytes(self) -> int:
        return self.cache_mgr.peak_cache_bytes

    def snapshot(self) -> Dict:
        """Full counter + timing snapshot."""
        snap = self.stats.snapshot()
        snap["peak_cache_bytes"] = self.peak_cache_bytes
        snap["timing"] = self.scheduler.timing()
        if self.cache_mode == "paged":
            snap["total_pages"] = self.cache_mgr.n_pages
            snap["page_size"] = self.cache_mgr.page_size
        return snap

    # ------------------------------------------------------------- intake
    def submit(self, reqs: List[Request]) -> None:
        self.scheduler.submit(reqs)
        # adaptive pool sizing sees the queue depth at submit
        self.cache_mgr.on_submit(self.scheduler.pending)

    # ------------------------------------- work-preserving recovery seam
    def checkpoint_slot(self, row: int) -> Optional[Dict]:
        """Capture a resumable generation checkpoint for an active slot.

        Called by a draining lease BEFORE it preempts the row, while its
        pages are resident.  Publishes the pages covering ``prompt +
        output[:-1]`` through the prefix store (the sub-page tail under an
        extended content key; nothing without a store) and returns a
        plain-dict record of the ORIGINAL prompt, the FULL output and the
        sampling position, which the caller persists durably; ``None``
        when there is nothing worth saving (empty row, prompt still
        ingesting, or no tokens emitted yet: full replay costs the same
        as a resume there)."""
        slot = self.scheduler.slots[row]
        req = slot.req
        if (req is None or slot.remaining_prompt
                or len(req.output) <= req.resume_base):
            return None
        # a request that is itself a resume carries resume_base pre-seeded
        # output tokens duplicated in its extended prompt: the record
        # always stores the ORIGINAL prompt and the FULL output, so
        # chained resumes never double-extend
        base = len(req.prompt) - req.resume_base
        resident = list(req.prompt[:base]) + req.output[:-1]
        self.cache_mgr.publish_generation(row, resident)
        self.stats.checkpoints_published += 1
        return {
            "uid": req.uid,
            "prompt": list(req.prompt[:base]),
            "output": list(req.output),
            "sample_stream": int(req.sample_stream),
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "stop_token": req.stop_token,
        }

    def submit_resume(self, ckpt: Dict) -> Request:
        """Admit a checkpointed generation for token-for-token continuation.

        The resumed request re-enters through the normal admission path
        with an *extended prompt* of ``prompt + output[:-1]`` and its
        output pre-seeded to ``output[:-1]``; the prefill-completion
        sample at the frontier re-derives ``output[-1]`` from the same
        stream key ``(stream, len(output) - 1)`` the original emission
        used, so the final output equals an uninterrupted run's and only
        the frontier token is decoded again.  The prefix stitch hits the
        pages the draining worker published (sub-page tail included); what
        no cache or store holds is chunk-prefilled, writing the same KV."""
        output = [int(t) for t in ckpt["output"]]
        req = Request(
            uid=ckpt["uid"],
            prompt=[int(t) for t in ckpt["prompt"]] + output[:-1],
            max_new_tokens=int(ckpt["max_new_tokens"]),
            temperature=float(ckpt["temperature"]),
            stop_token=ckpt.get("stop_token"),
        )
        req.output = output[:-1]
        req.resume_base = len(output) - 1
        req.sample_stream = int(ckpt["sample_stream"])
        self.scheduler.submit_resume(req)
        self.cache_mgr.on_submit(self.scheduler.pending)
        self.stats.checkpoint_resumes += 1
        self.stats.tokens_recovered += len(output) - 1
        return req

    def submit_handoff(self, rec: Dict) -> Request:
        """Admit a prefill worker's sealed handoff record on a decode
        worker.

        A handoff record is the checkpoint format with ``output == []``:
        the prompt was ingested and its full KV chain (full pages plus the
        sub-page tail under an extended content key) published by a
        prefill-role worker, but nothing was decoded.  Admission flags the
        request as a handoff, which routes the prefix stitch through the
        demand-driven hydration path, and counts a fallback if the store
        cannot cover the prompt (the slot then chunk-prefills the rest,
        writing the same KV).  The first sample draws from the record's
        stream at step 0, so the output equals a monolithic worker's."""
        req = Request(
            uid=rec["uid"],
            prompt=[int(t) for t in rec["prompt"]],
            max_new_tokens=int(rec["max_new_tokens"]),
            temperature=float(rec["temperature"]),
            stop_token=rec.get("stop_token"),
        )
        req.sample_stream = int(rec["sample_stream"])
        req.handoff = True
        self.scheduler.submit_handoff(req)
        self.cache_mgr.on_submit(self.scheduler.pending)
        self.stats.handoffs_admitted += 1
        return req

    # ------------------------------------------------------------- stepping
    def step(self) -> int:
        """One engine tick: admit queued requests into freed rows, ingest
        pending prompt chunks (bounded by the tick's prefill token budget),
        then advance the decode-ready rows: one decode dispatch (fused),
        one verify dispatch (speculative) or one decode dispatch per
        distinct row position (grouped; attention families only, since
        every extra dispatch would re-advance a recurrence).  A
        prefill-role tick ingests only: each prompt finishes at ingest
        completion, so a decode dispatch could only be a no-op."""
        self.scheduler.begin_tick()
        if not self.scheduler.has_active():
            return 0
        emitted = 0
        if self._use_prefill:
            emitted += self._ingest_prompts()
        if self.worker_role == "prefill":
            return emitted
        if self.dispatch_mode == "grouped":
            emitted += self._decode_tick_grouped()
        elif self.speculative != "off":
            emitted += self._decode_tick_spec()
        else:
            emitted += self._decode_tick_fused()
        return emitted

    # -- prompt ingestion (fused chunked prefill) ---------------------------
    def _plan_prefill(self, prefilling: List[int], left: Optional[int]) -> Dict[int, int]:
        """Per-row token counts for the next prefill dispatch under the
        remaining tick budget (``None`` = unbounded)."""
        C, slots = self.prefill_chunk, self.scheduler.slots
        if left is None:
            return {i: min(C, len(slots[i].remaining_prompt)) for i in prefilling}
        # fair-share the remaining budget (ceil of an even split each),
        # rotating the head row by tick so a budget smaller than the row
        # count cannot starve the same rows forever
        plan: Dict[int, int] = {}
        start = self.scheduler.tick % len(prefilling)
        order = prefilling[start:] + prefilling[:start]
        for idx, i in enumerate(order):
            share = -(-left // (len(order) - idx))
            n = min(C, len(slots[i].remaining_prompt), share)
            if n > 0:
                plan[i] = n
                left -= n
        return plan

    def _ingest_prompts(self) -> int:
        emitted = 0
        B, C = self.max_batch, self.prefill_chunk
        slots = self.scheduler.slots
        left = self.scheduler.prefill_token_budget
        while True:
            prefilling = [
                i for i, s in enumerate(slots)
                if s.req is not None and s.remaining_prompt
            ]
            if not prefilling or (left is not None and left <= 0):
                return emitted
            plan = self._plan_prefill(prefilling, left)
            if left is not None:
                left -= sum(plan.values())
            if not plan:
                return emitted
            if self.cache_mode == "paged":
                # reservation pass before building inputs: CoW / eviction /
                # preemption mutate slot state, and a later row's allocation
                # may preempt (or yield) an earlier one
                for i, n in plan.items():
                    s = slots[i]
                    if s.req is not None and s.remaining_prompt:
                        self.cache_mgr.ensure_pages(i, s.pos + n, write_start=s.pos)
            rows = [
                i for i in plan
                if slots[i].req is not None and slots[i].remaining_prompt
            ]
            if left is not None:
                # refund tokens planned for rows the reservation dropped: the
                # budget promises tokens ingested, not tokens planned
                left += sum(plan[i] for i in plan if i not in rows)
            if not rows:
                return emitted
            tokens = np.zeros((B, C), np.int64)
            offsets = np.zeros((B,), np.int64)
            lengths = np.zeros((B,), np.int64)
            meta = self._row_meta()
            for i in rows:
                slot = slots[i]
                n = min(plan[i], len(slot.remaining_prompt))
                tokens[i, :n] = slot.remaining_prompt[:n]
                offsets[i] = slot.pos
                lengths[i] = n
                self._fill_meta(meta, i, slot)
            self.cache_mgr.push_table()
            if self.sample_on_device:
                nxt, done, _ = self._prefill(self.params, self.cache_mgr.cache, tokens,
                                             offsets, lengths, *meta)
                nxt, done, lg = nxt.cpu().numpy(), done.cpu().numpy(), None
            else:
                logits, _ = self._prefill(self.params, self.cache_mgr.cache, tokens,
                                          offsets, lengths)
                nxt, done, lg = None, None, logits.float().cpu().numpy()
            self.stats.prefill_dispatches += 1
            self.stats.dispatches += 1
            self.heartbeat()
            for i in rows:
                slot = slots[i]
                n = min(plan[i], len(slot.remaining_prompt))
                del slot.remaining_prompt[:n]
                slot.pos += n
                self.stats.prompt_tokens_ingested += n
                if not slot.remaining_prompt:
                    # prompt fully resident: publish its full pages before
                    # accept (which may finish the row and drop its refs)
                    self.cache_mgr.prefix_insert(i, slot.req.prompt)
                    if self.worker_role == "prefill":
                        # disaggregated prefill: the prompt's whole KV chain
                        # (the sub-page tail too) is published while the row
                        # holds its pages, then the request finishes WITHOUT
                        # sampling: the decode worker's draw at (stream, 0)
                        # is the token a monolith would have emitted here
                        self.cache_mgr.publish_generation(i, slot.req.prompt)
                        self.cache_mgr.ensure_chain_published(i, slot.req.prompt)
                        self.scheduler.finish(i)
                        continue
                    self._accept_token(i, self._token(i, nxt, lg),
                                       bool(done[i]) if done is not None else None)
                    emitted += 1

    # -- decode -------------------------------------------------------------
    def _row_meta(self):
        B = self.max_batch
        return [np.zeros((B,), np.float32), np.zeros((B,), np.int64),
                np.zeros((B,), np.int64), np.full((B,), -1, np.int64),
                np.full((B,), 1 << 30, np.int64)]

    @staticmethod
    def _fill_meta(meta, i: int, slot: Slot) -> None:
        temps, streams, steps, stops, max_news = meta
        temps[i] = slot.req.temperature
        streams[i] = slot.req.sample_stream
        steps[i] = len(slot.req.output)
        if slot.req.stop_token is not None:
            stops[i] = slot.req.stop_token
        max_news[i] = slot.req.max_new_tokens

    def _build_decode_inputs(self):
        B = self.max_batch
        slots = self.scheduler.slots
        if self.cache_mode == "paged":
            # reservation pass first: allocation may CoW a shared page or
            # preempt/yield a slot, so inputs come only from the rows that
            # still hold their pages.  Rows held mid-prefill by the tick
            # budget are covered too: the batch-wide dispatch writes
            # (garbage) KV at their pos through their live table, so a
            # shared page there is privatized first; the row overwrites it
            # when its prefill resumes
            for i, s in enumerate(slots):
                if s.req is not None:
                    self.cache_mgr.ensure_pages(i, s.pos + 1, write_start=s.pos)
        tokens = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int64)
        meta = self._row_meta()
        active = []
        for i, slot in enumerate(slots):
            # parked rows keep their stale pos: their sentinel table row
            # masks the write out of a paged dispatch; a dense row is
            # zeroed at its next admission
            pos[i] = slot.pos
            if slot.req is None or self._mid_prefill(slot):
                continue
            active.append(i)
            if slot.remaining_prompt:  # decode-path ingestion
                tokens[i, 0] = slot.remaining_prompt[0]
            elif slot.req.output:
                tokens[i, 0] = slot.req.output[-1]
            else:
                tokens[i, 0] = slot.req.prompt[-1]
            self._fill_meta(meta, i, slot)
        return active, tokens, pos, meta

    def _mid_prefill(self, slot: Slot) -> bool:
        """Under a finite prefill budget a fused-prefill row can reach the
        decode tick with prompt tokens pending; it sits the decode out.
        (Without fused prefill, such rows are the decode-path ingestion.)"""
        return bool(self._use_prefill and slot.remaining_prompt)

    def _decode_dispatch(self, tokens, pos, meta):
        self.cache_mgr.push_table()
        if self.sample_on_device:
            nxt, done, _ = self._decode(self.params, self.cache_mgr.cache, tokens, pos, *meta)
            out = nxt.cpu().numpy(), done.cpu().numpy(), None
        else:
            logits, _ = self._decode(self.params, self.cache_mgr.cache, tokens, pos)
            out = None, None, logits.float().cpu().numpy()
        self.stats.decode_dispatches += 1
        self.stats.steps_executed += 1
        self.stats.dispatches += 1
        self.heartbeat()
        return out

    def _advance_rows(self, rows, nxt, done, lg) -> int:
        emitted = 0
        slots = self.scheduler.slots
        for i in rows:
            slot = slots[i]
            slot.pos += 1
            if slot.remaining_prompt:
                slot.remaining_prompt.pop(0)
                self.stats.prompt_tokens_ingested += 1
                if slot.remaining_prompt:
                    continue  # still ingesting the prompt
                self.cache_mgr.prefix_insert(i, slot.req.prompt)
            self._accept_token(i, self._token(i, nxt, lg),
                               bool(done[i]) if done is not None else None)
            emitted += 1
        return emitted

    def _decode_tick_fused(self) -> int:
        active, tokens, pos, meta = self._build_decode_inputs()
        if not active:
            return 0
        return self._advance_rows(active, *self._decode_dispatch(tokens, pos, meta))

    def _decode_tick_spec(self) -> int:
        """Speculative decode tick: propose up to ``spec_k`` drafts per
        decode-ready row, verify them and the bonus position in ONE
        chunk-extend dispatch, accept the longest consistent run and rewind
        the rejected positions.  Position ``t`` samples from the key
        ``(stream, len(output) + t)`` and emission stops at the first
        per-position done, so a request's output equals the
        non-speculative engine's; speculation only changes how many tokens
        land per dispatch.  A row with no drafts is a plain one-token
        decode inside the same dispatch."""
        B, T = self.max_batch, self.spec_k + 1
        slots = self.scheduler.slots
        ready = [i for i, s in enumerate(slots) if s.req is not None and not s.remaining_prompt]
        if not ready:
            return 0
        hists = {i: slots[i].req.prompt + slots[i].req.output for i in ready}
        drafts = self.proposer.propose(ready, hists, self.spec_k)
        plan: Dict[int, List[int]] = {}
        for i in ready:
            # cap drafts so a row never advances past the max_len - 1 point
            # where the non-speculative engine finishes it
            room = self.max_len - 2 - slots[i].pos
            plan[i] = list(drafts.get(i, []))[:max(0, room)]
        if self.cache_mode == "paged":
            # reservation pass first (see _build_decode_inputs).  Only the
            # base position carries full recovery; draft positions are
            # best-effort and shrink the plan under pool pressure, so
            # speculation never fails a workload the plain engine serves
            for i in ready:
                s = slots[i]
                if s.req is not None:
                    got = self.cache_mgr.reserve_speculative(
                        i, s.pos + 1, s.pos + 1 + len(plan[i]), write_start=s.pos)
                    if got is not None:
                        plan[i] = plan[i][:max(0, got - (s.pos + 1))]
        live = [i for i in ready if slots[i].req is not None]
        if not live:
            return 0
        tokens = np.zeros((B, T), np.int64)
        offsets = np.zeros((B,), np.int64)
        lengths = np.zeros((B,), np.int64)
        meta = self._row_meta()
        for i in live:
            s, d = slots[i], plan[i]
            tokens[i, 0] = s.req.output[-1] if s.req.output else s.req.prompt[-1]
            tokens[i, 1:1 + len(d)] = d
            offsets[i] = s.pos
            lengths[i] = 1 + len(d)
            self._fill_meta(meta, i, s)
            self.stats.draft_tokens_proposed += len(d)
        self.cache_mgr.push_table()
        tgt, n_emit, done, _ = self._verify(self.params, self.cache_mgr.cache, tokens,
                                            offsets, lengths, *meta)
        tgt, n_emit, done = tgt.cpu().numpy(), n_emit.cpu().numpy(), done.cpu().numpy()
        self.stats.decode_dispatches += 1
        self.stats.steps_executed += 1
        self.stats.dispatches += 1
        self.stats.spec_dispatches += 1
        self.heartbeat()
        emitted = 0
        for i in live:
            s = slots[i]
            n = int(n_emit[i])
            new_pos = s.pos + n
            if n < int(lengths[i]):
                # rejected positions: trailing whole pages go back to the
                # pool; stale KV inside the kept page sits past the frontier
                self.cache_mgr.rewind_slot(i, new_pos)
            s.pos = new_pos
            self.stats.draft_tokens_accepted += n - 1
            self.stats.spec_tokens_emitted += n
            for t in range(n):
                s.req.output.append(int(tgt[i, t]))
                self.stats.tokens_emitted += 1
                self.scheduler.on_token(i)
            emitted += n
            if bool(done[i]) or new_pos >= self.max_len - 1:
                self.scheduler.finish(i)
                self.proposer.release(i)
        return emitted

    def _decode_tick_grouped(self) -> int:
        """The per-position baseline: one decode dispatch per distinct row
        position.  Every dispatch carries the full position vector, so its
        cache writes are idempotent across the tick's dispatches; only the
        group's rows consume its outputs."""
        active, tokens, pos, meta = self._build_decode_inputs()
        if not active:
            return 0
        groups: Dict[int, List[int]] = {}
        for i in active:
            groups.setdefault(self.scheduler.slots[i].pos, []).append(i)
        emitted = 0
        for _, rows in sorted(groups.items()):
            emitted += self._advance_rows(rows, *self._decode_dispatch(tokens, pos, meta))
        return emitted

    # -- bookkeeping ---------------------------------------------------------
    def _token(self, row: int, nxt, lg) -> int:
        if nxt is not None:
            return int(nxt[row])
        req = self.scheduler.slots[row].req
        return self._host_sample(lg[row], req.temperature, stream=req.sample_stream,
                                 step=len(req.output))

    def _accept_token(self, row: int, tok: int, done: Optional[bool] = None) -> None:
        slot = self.scheduler.slots[row]
        slot.req.output.append(tok)
        self.stats.tokens_emitted += 1
        self.scheduler.on_token(row)
        if done is None:
            # host fallback (sample_on_device=False): re-derive the mask
            done = len(slot.req.output) >= slot.req.max_new_tokens or (
                slot.req.stop_token is not None and tok == slot.req.stop_token
            )
        if done or slot.pos >= self.max_len - 1:
            self.scheduler.finish(row)

    def _host_sample(self, lg_row: np.ndarray, temperature: float, stream: int,
                     step: int) -> int:
        """Host fallback sampler (``sample_on_device=False``): greedy, or a
        max-subtracted softmax draw from an rng keyed on ``(seed, stream,
        step)``, independent of scheduling and preemption replays."""
        lg = np.asarray(lg_row, np.float64)
        if temperature <= 0:
            return int(np.argmax(lg))
        p = np.exp((lg - lg.max()) / temperature)
        p /= p.sum()
        rng = np.random.default_rng((self._rng_seed, stream, step))
        return int(rng.choice(len(p), p=p))

    def run_to_completion(self, max_steps: int = 100_000) -> List[Request]:
        steps = 0
        while (
            self.scheduler.pending or self.scheduler.has_active()
        ) and steps < max_steps:
            self.step()
            steps += 1
        # drain seam: background prefix-store publishes must be durable
        # before callers compare counters or hand pages to another engine
        self.cache_mgr.flush_store()
        return self.scheduler.finished


def _stats_alias(name: str) -> property:
    """Read/write view of one EngineStats counter on the engine."""
    return property(
        lambda self: getattr(self.stats, name),
        lambda self, value: setattr(self.stats, name, value),
    )


def _cache_alias(name: str) -> property:
    return property(lambda self: getattr(self.cache_mgr, name))


for _name in (
    "steps_executed", "decode_dispatches", "prefill_dispatches", "dispatches",
    "tokens_emitted", "prompt_tokens_ingested",
    "pages_in_use", "peak_pages", "page_allocs", "page_bytes",
    "dense_cache_bytes",
    "prefix_hit_tokens", "prompt_tokens_skipped", "pages_shared_peak",
    "prefix_hit_tokens_partial", "cow_partial_stitches",
    "cow_copies", "prefix_evictions", "preemptions", "tokens_discarded",
    "prefix_store_pages_published", "prefix_store_pages_hydrated",
    "prefix_store_tokens_hydrated",
    "spec_dispatches", "draft_dispatches",
    "draft_tokens_proposed", "draft_tokens_accepted", "spec_tokens_emitted",
    "revocation_notices", "drain_requeued_requests", "requests_resumed",
    "lease_slices", "lease_resumes",
    "checkpoints_published", "checkpoint_resumes", "tokens_recovered",
    "checkpoint_fallbacks", "decode_tokens_discarded",
    "publish_retries", "prefix_store_hash_mismatches",
    "hydration_fetch_ops", "prefix_store_bytes_fetched", "publish_dedup_hits",
    "handoffs_published", "handoffs_admitted", "handoff_fallbacks",
    "handoff_seal_rejects",
):
    setattr(ServeEngine, _name, _stats_alias(_name))
for _name in (
    "page_size", "n_pages", "pages_per_slot",
    "_free_pages", "_page_refs", "_slot_pages", "_table",
):
    setattr(ServeEngine, _name, _cache_alias(_name))
del _name
