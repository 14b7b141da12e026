"""The bridge between the port's trees and the reference package's.

The reference stacks every layer's leaves along a leading ``L`` axis
(its layers run as a ``lax.scan``); the port keeps ``layers`` as a list
of per-layer dicts.  Both directions are here:

- ``to_reference_layout`` / ``from_reference_layout`` restack torch
  trees on their device: parameters, gradients and optimizer states
  alike (every dict whose ``layers`` is a list, or a stacked dict);
- ``params_from_jax`` / ``params_to_jax`` and ``opt_state_from_jax`` /
  ``opt_state_to_jax`` cross to and from the reference's numpy leaves
  (``jax.tree.map(np.asarray, tree)`` on its side).  Parity tests share
  weights this way, since the port's numpy-seeded init cannot draw what
  ``jax.random.normal`` draws; checkpoints restack through the torch pair.

This module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.ssm import FP32_PARAMS
from repro_torch.tree import tree_map, tree_map_with_path

Tree = Any


def to_reference_layout(tree: Tree) -> Tree:
    """Stack the per-layer list of every ``layers`` entry along a new
    leading axis (the reference's layout); other leaves are shared."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "layers" and isinstance(v, list):
            out[k] = tree_map(lambda *xs: torch.stack(xs), *v)
        else:
            out[k] = to_reference_layout(v)
    return out


def from_reference_layout(tree: Tree) -> Tree:
    """Split every stacked ``layers`` entry into the port's list of
    per-layer dicts (each leaf its own contiguous tensor)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "layers" and isinstance(v, dict):
            n = _leading(v)
            out[k] = [tree_map(lambda a, i=i: a[i].clone(), v) for i in range(n)]
        else:
            out[k] = from_reference_layout(v)
    return out


def _leading(tree: Tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])


def _tensor(a, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype)


def params_from_jax(
    np_params: Dict[str, Any], device=None, dtype: Optional[torch.dtype] = torch.float32
) -> Dict[str, Any]:
    """Port parameters from the reference's dense- or SSM-model pytree of
    numpy leaves (layers stacked along ``L``), converted to ``dtype``; an
    SSM's ``A_log``, ``D`` and ``dt_bias`` stay float32, as the reference
    keeps them in every model dtype."""
    device = resolve_device(device)
    if "dense_layers" in np_params or "layers" not in np_params or "shared" in np_params:
        raise NotImplementedError("params_from_jax takes the dense or SSM family's pytree only")

    def leaf(path, a):
        return _tensor(a, device, torch.float32 if path[-1] in FP32_PARAMS else dtype)

    return from_reference_layout(tree_map_with_path(leaf, np_params))


def _numpy(t) -> np.ndarray:
    """A leaf as numpy: bf16 (which numpy lacks) widens to float32."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(t)


def params_to_jax(params: Tree) -> Tree:
    """The reference's pytree of numpy leaves (layers stacked) from port
    parameters; feed it to JAX with ``jax.tree.map(jnp.asarray, ...)``."""
    return tree_map(_numpy, to_reference_layout(params))


def opt_state_to_jax(state: Tree) -> Tree:
    """``train.optimizer`` state in the reference's layout: the step as an
    int32 scalar, moments (and master) stacked, int8 moments kept int8."""
    out = tree_map(_numpy, to_reference_layout({k: v for k, v in state.items() if k != "step"}))
    out["step"] = np.asarray(int(state["step"]), np.int32)
    return out


def opt_state_from_jax(np_state: Tree, device=None) -> Tree:
    """``train.optimizer`` state from the reference's (numpy leaves; each
    leaf keeps its dtype: float32 moments, int8 ``q`` with float32
    ``scale``)."""
    device = resolve_device(device)
    rest = {k: v for k, v in np_state.items() if k != "step"}
    out = from_reference_layout(
        tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), rest))
    out["step"] = int(np.asarray(np_state["step"]))
    return out
