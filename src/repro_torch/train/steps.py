"""Step builders: ``train_step``, the prefill step and the decode step.

Counterpart of the reference package's ``train/steps.py``:

    train_step(params, opt_state, batch, rng) -> (params, opt_state, metrics)

- gradients through ``torch.autograd`` (the reference's
  ``jax.value_and_grad``), with microbatch accumulation in f32, bf16 or
  int8 (stochastic rounding keyed ``fold_in(rng, i)``);
- the AdamW update (``train.optimizer``).

``rng`` is a ``prng`` key (an int64 ``(2,)`` tensor), the same key the
reference would pass, so int8 accumulation rounds as the reference does.
By default the step is functional like the reference's
``make_train_step``: it returns new parameter and state trees and leaves
its inputs untouched.  ``make_train_step(..., donate=True)`` is the
counterpart of the reference's ``jax.jit(train_step, donate_argnums=(0,
1))``, which its training loop and train cells run: the update writes
into the parameter and optimizer-state tensors it was given
(``train.optimizer.adamw_update_``), so the state is held once, not
twice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import prng
from repro_torch.models.weights import from_reference_layout, to_reference_layout
from repro_torch.train import compression, optimizer
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    accum_dtype: str = "f32"  # f32 | bf16 | int8 (stochastic rounding)
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def make_loss_fn(model) -> Callable:
    def loss_fn(params: Tree, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        return model.loss(params, batch)

    return loss_fn


def _value_and_grad(loss_fn: Callable, params: Tree, batch) -> Tuple[torch.Tensor, Tree]:
    """The loss and its gradient tree, from fresh leaves that alias
    ``params`` (nothing is accumulated on the caller's tensors).  Over a
    mesh each gradient is laid out as its parameter (a partial sum is
    reduced), as GSPMD lays out the reference's."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(leaves, batch)[0]
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat)
    by_id = {id(t): _like(g, t) for t, g in zip(flat, grads)}
    return loss.detach(), tree_map(lambda t: by_id[id(t)], leaves)


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _mean_in_place(acc: Tree, m: int) -> Tree:
    """``acc``'s leaves replaced one by one, in their containers, by their
    f32 mean over ``m`` microbatches: each sum is freed as its mean is
    made."""
    if isinstance(acc, dict):
        for key, v in acc.items():
            acc[key] = _mean_in_place(v, m)
        return acc
    if isinstance(acc, list):
        for i, v in enumerate(acc):
            acc[i] = _mean_in_place(v, m)
        return acc
    return (acc / m).float()


def make_train_step(model, tcfg: TrainStepConfig, donate: bool = False) -> Callable:
    """``train_step(params, opt_state, batch, rng) -> (params, opt_state,
    metrics)``.  With ``donate`` the parameters and optimizer state are
    updated in place (``adamw_update_``) and the returned trees are the
    ones passed in: after a step the caller's old trees hold the new
    values, where the reference deletes its donated buffers.  The
    microbatch accumulator is summed in place and freed leaf by leaf
    before the update, and each gradient as soon as its leaf is written:
    bit for bit the functional step.  A tree whose leaves
    share storage is refused with ``ValueError``."""
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch, rng):
        m = tcfg.microbatches
        if m == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            acc_dtype = torch.bfloat16 if tcfg.accum_dtype == "bf16" else torch.float32
            # laid out as the parameters (a DTensor's zeros over a mesh)
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype), params)
            total = 0.0
            for i in range(m):
                mb = {k: v[i * (v.shape[0] // m):(i + 1) * (v.shape[0] // m)]
                      for k, v in batch.items()}
                loss_i, g = _value_and_grad(loss_fn, params, mb)
                if tcfg.accum_dtype == "bf16":
                    g = compression.cast_tree(g, torch.bfloat16)
                elif tcfg.accum_dtype == "int8":
                    ref = to_reference_layout(g)
                    ref = compression.decompress_tree(
                        compression.compress_tree(ref, prng.fold_in(rng, i)), ref)
                    g = from_reference_layout(ref)
                if donate:  # the reference's scan carries the sum in its buffers
                    tree_map(lambda a, b: a.add_(b.to(a.dtype)), acc, g)
                else:
                    acc = tree_map(lambda a, b: a + b.to(a.dtype), acc, g)
                total = total + loss_i
                del g
            if donate:
                grads, acc = _mean_in_place(acc, m), None
            else:
                grads = tree_map(lambda g: (g / m).float(), acc)
            loss = total / m
        if donate:
            # the update takes the last reference to the gradients and
            # drops each once its leaf is written
            new_params, new_opt, opt_metrics = optimizer.adamw_update_(
                params, grads, opt_state, tcfg.opt)
        else:
            new_params, new_opt, opt_metrics = adamw_update(params, grads, opt_state, tcfg.opt)
        return new_params, new_opt, {"loss": loss, **opt_metrics}

    return train_step


def make_prefill_step(model) -> Callable:
    def prefill_step(params, tokens):
        return model.prefill(params, tokens)

    return prefill_step


def make_decode_step(model) -> Callable:
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return decode_step
