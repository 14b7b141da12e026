"""Token sampling and the done mask, run on the dispatch's device.

Counterpart of the reference package's ``serving/sampling.py``.  Only
``B`` token ids and ``B`` done flags leave the device per dispatch.

Determinism contract: each request owns a sampling *stream* (assigned
at submit) and each emitted token a *step* (tokens already generated),
so a row's draws never depend on its batch placement, slot or the
dispatch schedule.  Greedy rows take the first index of the maximum, as
the reference does.  Temperature rows use the Gumbel-max trick on
max-subtracted logits, with each row's noise drawn as the reference
draws it: ``gumbel(fold_in(fold_in(PRNGKey(base_seed), stream), step),
(V,))`` from the port's copy of JAX's threefry stream (``prng``), for all
temperature rows at once on the logits' device.  The sampled ids equal
the reference's except at a near-tie, where the two libraries' ``log``
may differ by an ulp.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import prng


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
    rows = np.flatnonzero(np.asarray(temps) > 0)
    if rows.size == 0:
        return out
    dev = lg.device
    idx = torch.as_tensor(rows, device=dev)
    keys = prng.fold_in(
        prng.fold_in(prng.PRNGKey(base_seed, device=dev),
                     torch.as_tensor(np.asarray(streams)[rows], device=dev)),
        torch.as_tensor(np.asarray(steps)[rows], device=dev))
    noise = prng.gumbel(keys, lg.shape[-1:])  # (n, V)
    t = torch.as_tensor(np.asarray(temps, np.float32)[rows], device=dev)
    sel = lg[idx]
    z = (sel - sel.max(dim=-1, keepdim=True).values) / t[:, None] + noise
    out[idx] = torch.argmax(z, dim=-1)
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
        device = params["embed"].device
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
        device = params["embed"].device
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
