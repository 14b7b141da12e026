"""Data pipeline: deterministic, shardable, resumable.

Counterpart of the reference package's ``train/data.py``:

- :class:`SyntheticLM`: ``batch(step)`` is a pure function of
  ``(seed, step, dp_rank)``, drawn through ``prng`` (JAX's threefry
  stream reproduced), so its batches equal the reference's token for
  token and a resumed job regenerates the same data;
- :class:`TokenFileDataset`: a memory-mapped token corpus cut into
  fixed windows, strided by ``(dp_rank, n_dp)``.

Batches are int64 tensors on the dataset's device (``cuda`` unless the
caller names the CPU).  An encoder-decoder's batch also holds ``frames``,
the audio stub's frame embeddings ``(local, encoder_seq, d_model)``
float32 from ``normal(fold_in(key, 7))``, and a VLM's ``patches``, the
stub frontend's patch embeddings ``(local, n_vision_tokens, d_model)``
float32 from ``normal(fold_in(key, 8))``, each as the reference draws
them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0


class SyntheticLM:
    """Zipf-ish synthetic tokens with enough structure for loss to fall:
    each row is random tokens or a repeated 8-token motif."""

    def __init__(self, cfg: ArchConfig, data: DataConfig, device=None):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)

    def batch(self, step: int, *, dp_rank: int = 0, n_dp: int = 1) -> Dict[str, torch.Tensor]:
        d = self.data
        if d.global_batch % n_dp:
            raise ValueError(f"global_batch {d.global_batch} !% dp {n_dp}")
        local = d.global_batch // n_dp
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(d.seed, device=self.device), step),
                           dp_rank)
        k1, k2, k3 = prng.split(key, 3)
        v = self.cfg.vocab_size
        base = prng.randint(k1, (local, d.seq_len + 1), 0, v)
        motif = prng.randint(k2, (local, 8), 0, v)
        reps = motif.repeat(1, (d.seq_len + 8) // 8)[:, : d.seq_len + 1]
        use_motif = prng.bernoulli(k3, 0.5, (local, 1))
        toks = torch.where(use_motif, reps, base)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.is_encoder_decoder:
            batch["frames"] = prng.normal(prng.fold_in(key, 7),
                                          (local, self.cfg.encoder_seq, self.cfg.d_model))
        if self.cfg.n_vision_tokens:
            batch["patches"] = prng.normal(prng.fold_in(key, 8),
                                           (local, self.cfg.n_vision_tokens, self.cfg.d_model))
        return batch


class TokenFileDataset:
    """Memory-mapped uint16/uint32 token file -> fixed windows.  Window i
    of shard r covers tokens ``[(i * n_dp + r) * seq_len, ...)``, so any
    worker can compute any batch."""

    def __init__(self, path: str, cfg: ArchConfig, data: DataConfig, dtype=np.uint16,
                 device=None):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)

    def n_batches(self, n_dp: int = 1) -> int:
        per = self.data.seq_len + 1
        windows = len(self.tokens) // per
        return windows // self.data.global_batch

    def batch(self, step: int, *, dp_rank: int = 0, n_dp: int = 1) -> Dict[str, torch.Tensor]:
        d = self.data
        local = d.global_batch // n_dp
        per = d.seq_len + 1
        rows = []
        for b in range(local):
            widx = step * d.global_batch + dp_rank * local + b
            start = widx * per
            rows.append(np.asarray(self.tokens[start: start + per], dtype=np.int64))
        toks = torch.from_numpy(np.stack(rows) % self.cfg.vocab_size).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def write_synthetic_corpus(path: str, n_tokens: int, vocab: int, seed: int = 0) -> str:
    """Materialize a synthetic corpus file (used by examples/tests)."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, min(vocab, 65535), size=n_tokens, dtype=np.uint16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr.tofile(path)
    return path
