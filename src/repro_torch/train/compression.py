"""Gradient compression for the microbatch accumulator: blockwise int8
with stochastic rounding (unbiased: E[q(x)] = x), and a bf16 cast.

Counterpart of the reference package's ``train/compression.py``.  The
rounding draws come from ``prng`` (JAX's threefry stream reproduced), so
on the same gradients and key the port rounds every element as the
reference does.  ``compress_tree`` splits its key over the leaves in
JAX's flatten order, so callers pass trees in the reference's layout
(``models.weights.to_reference_layout``: layers stacked along ``L``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.tree import tree_leaves_with_path, tree_map, tree_map_with_path

Tree = Any

QBLOCK = 256


def stochastic_round_int8(x: torch.Tensor, key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Blockwise (last-dim) int8 with stochastic rounding."""
    x = x.float()
    shape = tuple(x.shape) if x.dim() else (1,)
    d = shape[-1]
    nb = max(1, -(-d // QBLOCK))
    blocks = F.pad(x.reshape(shape), (0, nb * QBLOCK - d)).reshape(shape[:-1] + (nb, QBLOCK))
    scale = (blocks.abs().amax(dim=-1) / 127.0).clamp_min(1e-20)
    y = blocks / scale[..., None]
    lo = torch.floor(y)
    frac = y - lo
    u = prng.uniform(key.to(x.device), y.shape)
    q = torch.clamp(lo + (u < frac).float(), -127, 127)
    q = q.reshape(shape[:-1] + (nb * QBLOCK,))[..., :d].to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale}


def dequant_int8(qd: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    q, scale = qd["q"], qd["scale"]
    s = tuple(q.shape) if q.dim() else (1,)
    d = s[-1]
    nb = scale.shape[-1]
    qp = F.pad(q.reshape(s).float(), (0, nb * QBLOCK - d))
    blocks = qp.reshape(s[:-1] + (nb, QBLOCK)) * scale[..., None]
    return blocks.reshape(s[:-1] + (nb * QBLOCK,))[..., :d].reshape(shape)


def compress_tree(grads: Tree, key: torch.Tensor) -> Tree:
    """Each leaf rounded with its own key, ``split(key, n_leaves)`` taken in
    JAX's flatten order."""
    order = {path: i for i, (path, _) in enumerate(tree_leaves_with_path(grads))}
    keys = prng.split(key, len(order))
    return tree_map_with_path(lambda path, g: stochastic_round_int8(g, keys[order[path]]), grads)


def decompress_tree(comp: Tree, like: Tree) -> Tree:
    return tree_map(lambda leaf, c: dequant_int8(c, leaf.shape), like, comp)


def cast_tree(grads: Tree, dtype: torch.dtype) -> Tree:
    return tree_map(lambda g: g.to(dtype), grads)
