"""Weights carried across from the reference package.

The port cannot reproduce ``jax.random`` initialisation, so parity tests
share weights: the caller turns the reference ``Model.init`` pytree into
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
:func:`params_from_jax` turns those into the port's parameters.  This
module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(a, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype)


def params_from_jax(
    np_params: Dict[str, Any], device=None, dtype: Optional[torch.dtype] = torch.float32
) -> Dict[str, Any]:
    """Port parameters from the reference's dense-model pytree.

    ``np_params["layers"]`` stacks every layer's leaves along a leading
    ``L`` axis; it is unstacked into the port's list of per-layer dicts.
    Every other leaf keeps its shape (weights are ``(d_in, d_out)`` in
    both packages)."""
    device = resolve_device(device)
    if "dense_layers" in np_params or "layers" not in np_params:
        raise NotImplementedError("params_from_jax takes the dense family's pytree only")

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        return _tensor(tree, device, dtype)

    stacked = np_params["layers"]
    n_layers = len(np.asarray(stacked["ln1"]["w"]))

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return _tensor(np.asarray(tree)[i], device, dtype)

    out = {k: convert(v) for k, v in np_params.items() if k != "layers"}
    out["layers"] = [layer(stacked, i) for i in range(n_layers)]
    return out
