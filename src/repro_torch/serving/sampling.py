"""Token sampling and the done mask, run on the dispatch's device.

Counterpart of the reference package's ``serving/sampling.py``.  Only
``B`` token ids and ``B`` done flags leave the device per dispatch; a
speculative verify dispatch (:func:`make_verify_step`) sends ``(B, T)``
ids, ``B`` emit counts and ``B`` done flags.

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


def sample_tokens_chunk(
    logits: torch.Tensor,  # (B, T, V) unnormalized, one position per draft slot
    temps: np.ndarray,  # (B,)
    streams: np.ndarray,  # (B,)
    steps: np.ndarray,  # (B,) tokens already generated BEFORE this chunk
    *,
    base_seed: int,
) -> torch.Tensor:
    """Per-position sampling for the speculative verify dispatch: position
    ``t`` of row ``b`` draws from the key ``(streams[b], steps[b] + t)``,
    the key sequential decoding would use for that token, so the verified
    tokens are the ones ``T`` decode dispatches would have sampled, greedy
    and temperature rows alike."""
    B, T, V = logits.shape
    flat = sample_tokens(
        logits.reshape(B * T, V),
        np.repeat(np.asarray(temps, np.float32), T),
        np.repeat(np.asarray(streams, np.int64), T),
        (np.asarray(steps, np.int64)[:, None] + np.arange(T)[None, :]).reshape(-1),
        base_seed=base_seed,
    )
    return flat.reshape(B, T)


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


def make_verify_step(model, base_seed: int) -> Callable:
    """The speculative verify dispatch: one chunk-extend scores all ``k+1``
    positions (the last accepted token and ``k`` drafts), samples the
    target token at each, and applies the acceptance rule on the device.

    Row ``b`` carries ``tokens[b] = [x0, d1 .. dm, pad...]`` with
    ``lengths[b] = 1 + m`` (``0`` parks the row).  Draft ``d_{t+1}`` is
    consistent iff it equals the target sampled at position ``t``; the
    row emits ``tgt[b, :n_emit[b]]``: the longest consistent run plus one
    bonus target, cut after the first position whose token finishes the
    request (stop token or new-token budget).

    Returns ``(tgt (B, T), n_emit (B,), done (B,), cache)`` on the device."""
    vocab = model.cfg.vocab_size

    def step(params, cache, tokens, offsets, lengths, temps, streams, steps, stops,
             max_news):
        device = params["embed"].device
        tok, off, ln, st, sp, mx = _on(device, tokens, offsets, lengths, steps, stops,
                                       max_news)
        logits, cache = model.verify_chunk(params, cache, tok, off, ln)
        T = tok.shape[1]
        t_idx = torch.arange(T, device=device)
        tgt = sample_tokens_chunk(logits[:, :, :vocab], temps, streams, steps,
                                  base_seed=base_seed)
        # longest consistent run: draft t+1 survives iff it exists and every
        # draft before it survived
        match = (tok[:, 1:] == tgt[:, :-1]) & (t_idx[None, 1:] < ln[:, None])
        emit_cap = torch.cumprod(match.long(), dim=1).sum(dim=1) + 1  # + the bonus token
        # per-position done: tgt[b, t] is the request's (steps[b] + t + 1)-th token
        hit_stop = (sp[:, None] >= 0) & (tgt == sp[:, None])
        over = st[:, None] + t_idx[None, :] + 1 >= mx[:, None]
        pos_done = (hit_stop | over) & (t_idx[None, :] < emit_cap[:, None])
        done = pos_done.any(dim=1)
        n_emit = torch.where(done, pos_done.long().argmax(dim=1) + 1, emit_cap)
        n_emit = torch.where(ln > 0, n_emit, torch.zeros_like(n_emit))
        return tgt, n_emit, done, cache

    return step
