"""Token sampling and the done mask, run on the dispatch's device.

Counterpart of the reference package's ``serving/sampling.py``.  Only
``B`` token ids and ``B`` done flags leave the device per dispatch.

Determinism contract: each request owns a sampling *stream* (assigned
at submit) and each emitted token a *step* (tokens already generated),
so a row's draws never depend on its batch placement, slot or the
dispatch schedule.  Greedy rows take the first index of the maximum, as
the reference does.  Temperature rows use the Gumbel-max trick on
max-subtracted logits with noise from a ``torch.Generator`` seeded from
``(base_seed, stream, step)``; the reference draws its noise from JAX's
threefry stream, so temperature samples agree with it in distribution
and determinism, not bit for bit (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _row_seed(base_seed: int, stream: int, step: int) -> int:
    state = np.random.SeedSequence([base_seed, stream, step]).generate_state(1, np.uint64)
    return int(state[0])


def sample_tokens(
    logits: torch.Tensor,  # (B, V) unnormalized
    temps: np.ndarray,  # (B,) 0 = greedy (host metadata)
    streams: np.ndarray,  # (B,) per-request sampling stream ids
    steps: np.ndarray,  # (B,) tokens already generated per request
    *,
    base_seed: int,
) -> torch.Tensor:
    """One token per row, on ``logits``' device; greedy rows are a plain
    argmax, temperature rows a Gumbel-max draw."""
    lg = logits.float()
    out = torch.argmax(lg, dim=-1)
    for i in np.flatnonzero(np.asarray(temps) > 0):
        gen = torch.Generator(device=lg.device)
        gen.manual_seed(_row_seed(base_seed, int(streams[i]), int(steps[i])))
        u = torch.rand(lg.shape[-1], generator=gen, device=lg.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        z = (lg[i] - lg[i].max()) / float(temps[i]) + gumbel
        out[i] = torch.argmax(z)
    return out


def done_mask(
    nxt: torch.Tensor,  # (B,) sampled token ids
    steps: torch.Tensor,  # (B,) tokens already generated (before this one)
    stops: torch.Tensor,  # (B,) stop token id, -1 = no stop token
    max_news: torch.Tensor,  # (B,) per-request new-token budget
) -> torch.Tensor:
    """Per-row request-finished mask, computed with the sample."""
    hit_stop = (stops >= 0) & (nxt == stops)
    return hit_stop | (steps + 1 >= max_news)


def _on(device, *arrays, dtype=torch.long):
    return [torch.as_tensor(np.asarray(a), dtype=dtype).to(device) for a in arrays]


def make_decode_step(model, base_seed: int, on_device: bool) -> Callable:
    """The engine's decode dispatch: per-row-position decode, then
    sampling and the done mask on the device (default), or the raw logits
    for the host-sampling fallback.  Inputs are the engine's numpy arrays."""
    vocab = model.cfg.vocab_size

    def logits_step(params, cache, tokens, pos):
        device = cache["page_table"].device
        tok, p = _on(device, tokens, pos)
        logits, cache = model.decode_step(params, cache, tok, p)
        return logits[:, 0, :vocab], cache

    if not on_device:
        return logits_step

    def step(params, cache, tokens, pos, temps, streams, steps, stops, max_news):
        logits, cache = logits_step(params, cache, tokens, pos)
        nxt = sample_tokens(logits, temps, streams, steps, base_seed=base_seed)
        st, sp, mx = _on(logits.device, steps, stops, max_news)
        return nxt, done_mask(nxt, st, sp, mx), cache

    return step


def make_prefill_step(model, base_seed: int, on_device: bool) -> Callable:
    """The engine's fused chunked-prefill dispatch (last-token logits
    sampled on the device with the done mask, or returned raw for the
    host fallback)."""
    vocab = model.cfg.vocab_size

    def logits_step(params, cache, tokens, offsets, lengths):
        device = cache["page_table"].device
        tok, off, ln = _on(device, tokens, offsets, lengths)
        logits, cache = model.prefill_chunk(params, cache, tok, off, ln)
        return logits[:, :vocab], cache

    if not on_device:
        return logits_step

    def step(params, cache, tokens, offsets, lengths, temps, streams, steps, stops,
             max_news):
        logits, cache = logits_step(params, cache, tokens, offsets, lengths)
        nxt = sample_tokens(logits, temps, streams, steps, base_seed=base_seed)
        st, sp, mx = _on(logits.device, steps, stops, max_news)
        return nxt, done_mask(nxt, st, sp, mx), cache

    return step
