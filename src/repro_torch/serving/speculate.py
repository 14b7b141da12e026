"""Speculative-decoding proposers for the serving engine.

Counterpart of the reference package's ``serving/speculate.py``.  A
speculative decode tick splits into *propose* (guess up to ``k`` tokens
per decode-ready row) and *verify* (one chunk-extend dispatch of the
target model scores all ``k + 1`` positions and accepts the longest
consistent run, :func:`repro_torch.serving.sampling.make_verify_step`).
Two proposers share one interface:

- :class:`NgramProposer`: prompt-lookup decoding from the row's own
  history (prompt + output), host-only;
- :class:`DraftProposer`: a small draft model decoding greedily ahead of
  the target from its own paged KV cache on the engine's device.

Contract: ``propose(rows, histories, k)`` returns ``{row: [d1..dm]}``
with ``m <= k`` (an absent row or an empty list makes that row a plain
one-token decode inside the same verify dispatch); proposals never change
the target's sampled tokens, only how many land per dispatch; and
``release(row)`` drops a row's state when the engine retires its slot (a
stale row is also resynced lazily on its next propose).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.serving.cache_manager import KVCacheManager
from repro_torch.serving.sampling import _on
from repro_torch.serving.types import EngineStats

# the n-gram orders an NgramProposer indexes, as the reference's defaults
_NGRAM_ORDERS = range(1, 4)


class NgramProposer:
    """Prompt-lookup proposer: the modal n-gram continuation over the
    row's own history.

    Per row, an order-``n`` table (``n`` in ``_NGRAM_ORDERS``)
    counts every next token seen after each n-gram of the history.  A
    draft rolls forward from the current suffix: at each of the ``k``
    steps the longest n-gram with a recorded continuation votes (majority
    wins, falling back to shorter n-grams), and the prediction extends the
    lookup context only; drafted tokens are never counted into the tables.
    The tables grow incrementally while a row's history extends what was
    indexed; any other history (preemption, re-admission, slot reuse)
    rebuilds them."""

    def __init__(self):
        # per row: the indexed history and {n: {ngram: Counter(next)}}
        self._hist: Dict[int, List[int]] = {}
        self._tables: Dict[int, Dict[int, Dict[tuple, Counter]]] = {}

    def _update(self, row: int, hist: List[int]) -> None:
        old = self._hist.get(row)
        if old is None or len(old) > len(hist) or old != hist[:len(old)]:
            self._tables[row] = {n: defaultdict(Counter) for n in _NGRAM_ORDERS}
            start = 0
        else:
            start = len(old)
        tables = self._tables[row]
        for n in _NGRAM_ORDERS:
            for i in range(max(n, start), len(hist)):
                tables[n][tuple(hist[i - n:i])][hist[i]] += 1
        self._hist[row] = list(hist)

    def propose(self, rows: Sequence[int], histories: Dict[int, List[int]],
                k: int) -> Dict[int, List[int]]:
        out = {}
        for i in rows:
            self._update(i, histories[i])
            out[i] = self._roll(i, histories[i], k)
        return out

    def _roll(self, row: int, hist: List[int], k: int) -> List[int]:
        tables = self._tables[row]
        ctx = list(hist)
        drafts: List[int] = []
        for _ in range(k):
            nxt = None
            for n in range(min(_NGRAM_ORDERS[-1], len(ctx)), _NGRAM_ORDERS[0] - 1, -1):
                votes = tables[n].get(tuple(ctx[-n:]))
                if votes:
                    nxt = votes.most_common(1)[0][0]
                    break
            if nxt is None:
                break
            drafts.append(nxt)
            ctx.append(nxt)
        return drafts

    def release(self, row: int) -> None:
        self._hist.pop(row, None)
        self._tables.pop(row, None)


class DraftProposer:
    """Small-model proposer with its own paged KV cache.

    The draft model decodes ``k`` tokens greedily ahead of the target from
    the row's accepted history.  Its cache is a private
    :class:`KVCacheManager` over ``max_len + spec_k`` positions a row,
    fully reserved and without a prefix cache, so it never evicts or
    preempts.  Per row it records which tokens its cache holds; each
    propose rewinds a row to the longest common prefix of that record and
    the row's history, catches the missing history up through the draft's
    chunked prefill (chunks of 32), then runs ``k`` greedy decode
    dispatches.  ``stats`` is the target engine's counter block: every
    draft dispatch counts in ``draft_dispatches``."""

    _CATCHUP_CHUNK = 32

    def __init__(self, model, params, *, max_batch: int, max_len: int, spec_k: int,
                 device: torch.device, stats: EngineStats, page_size: int = 16):
        if not model.supports_paged_cache:
            raise ValueError(
                "draft proposer needs a pageable draft-model KV cache; arch "
                f"{model.cfg.name!r} (family {model.cfg.family!r}) has none"
            )
        if not model.supports_fused_prefill:
            raise ValueError(
                "draft proposer catches up history via fused prefill; arch "
                f"{model.cfg.name!r} does not support it"
            )
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.stats = stats
        self.device = device
        # drafting runs up to spec_k positions past the target's frontier,
        # so a draft row reserves max_len + spec_k positions, all up front
        draft_len = max_len + spec_k
        pages_per_slot = -(-draft_len // page_size)
        self.cache = KVCacheManager(
            model, max_batch=max_batch, max_len=draft_len, stats=EngineStats(),
            device=device, cache_mode="paged", page_size=page_size,
            total_pages=max_batch * pages_per_slot, prefix_cache=False,
        )
        # the tokens whose KV is resident per row, positions 0..len-1
        self._tokens: List[List[int]] = [[] for _ in range(max_batch)]

    # ---------------------------------------------------------------- state
    def _resync(self, rows, histories) -> None:
        """Rewind each row's draft cache to the longest common prefix of
        its resident tokens and the row's accepted history."""
        for i in rows:
            hist, res = histories[i], self._tokens[i]
            lcp = 0
            for a, b in zip(res, hist):
                if a != b:
                    break
                lcp += 1
            if lcp < len(res):
                self.cache.rewind_slot(i, lcp)
                del res[lcp:]

    def release(self, row: int) -> None:
        self.cache.rewind_slot(row, 0)
        self._tokens[row] = []

    # -------------------------------------------------------------- propose
    def propose(self, rows: Sequence[int], histories: Dict[int, List[int]],
                k: int) -> Dict[int, List[int]]:
        rows = [i for i in rows if len(histories[i]) > 0]
        if not rows or k <= 0:
            return {}
        self._resync(rows, histories)
        # make hist[:-1] resident; the last history token goes through the
        # decode dispatch below so its logits seed the drafts
        self._catch_up(rows, histories)
        B, vocab = self.max_batch, self.model.cfg.vocab_size
        drafts: Dict[int, List[int]] = {i: [] for i in rows}
        feed = {i: histories[i][-1] for i in rows}
        for _ in range(k):
            tokens = np.zeros((B, 1), np.int64)
            pos = np.zeros((B,), np.int64)
            for i in rows:
                # the pool is fully reserved: this can neither yield nor preempt
                self.cache.ensure_pages(i, len(self._tokens[i]) + 1,
                                        write_start=len(self._tokens[i]))
                tokens[i, 0] = feed[i]
                pos[i] = len(self._tokens[i])
            self.cache.push_table()
            logits, _ = self.model.decode_step(self.params, self.cache.cache,
                                               *_on(self.device, tokens, pos))
            nxt = torch.argmax(logits[:, 0, :vocab].float(), dim=-1).cpu().numpy()
            self.stats.draft_dispatches += 1
            for i in rows:
                self._tokens[i].append(feed[i])
                feed[i] = int(nxt[i])
                drafts[i].append(feed[i])
        return drafts

    def _catch_up(self, rows, histories) -> None:
        B, C = self.max_batch, self._CATCHUP_CHUNK
        while True:
            todo = [i for i in rows if len(self._tokens[i]) < len(histories[i]) - 1]
            if not todo:
                return
            tokens = np.zeros((B, C), np.int64)
            offsets = np.zeros((B,), np.int64)
            lengths = np.zeros((B,), np.int64)
            plan: Dict[int, List[int]] = {}
            for i in todo:
                res = len(self._tokens[i])
                chunk = histories[i][res:min(res + C, len(histories[i]) - 1)]
                self.cache.ensure_pages(i, res + len(chunk), write_start=res)
                tokens[i, :len(chunk)] = chunk
                offsets[i] = res
                lengths[i] = len(chunk)
                plan[i] = chunk
            self.cache.push_table()
            self.model.prefill_chunk(self.params, self.cache.cache,
                                     *_on(self.device, tokens, offsets, lengths))
            self.stats.draft_dispatches += 1
            for i, chunk in plan.items():
                self._tokens[i].extend(chunk)
