"""Checkpoints in the reference package's on-store format.

Counterpart of the reference's ``train/checkpoint.py``: every leaf is
written as one ``.npy`` object, then the manifest, last (the atomicity
barrier: a checkpoint without its manifest does not exist):

    ckpt/<run>/<step>/manifest.json
    ckpt/<run>/<step>/<leaf.path>.npy

Leaf names join the tree path with ``.`` in JAX's flatten order, over
the reference's layout (layers stacked along ``L``; the port's trees
are restacked by ``models.weights``), and bf16 leaves are stored as the
reference stores them, 2-byte void records with ``"dtype": "bfloat16"``
in the manifest.  Numpy has no bf16 and the port does not depend on
``ml_dtypes``: it writes and reads those records through ``int16``.  So
each package restores the other's checkpoints.
"""

from __future__ import annotations

import hashlib
import io
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.storage import ObjectStore
from repro_torch.models.weights import from_reference_layout, to_reference_layout
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

Tree = Any


def _leaf_key(path) -> str:
    return ".".join(str(k) for k in path)


def _npy_bytes(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, x, allow_pickle=False)
    return buf.getvalue()


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array to store and the dtype name the manifest gives."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf, np.int32) if isinstance(leaf, int) else np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(store: ObjectStore, run: str, step: int, tree: Tree, *,
                    extra_meta: Optional[Dict] = None) -> str:
    """Write every leaf of ``tree`` (in the reference's layout), then the
    manifest."""
    prefix = f"ckpt/{run}/{step}"
    leaves = []
    for path, leaf in tree_leaves_with_path(tree):
        key = _leaf_key(path)
        arr, dtype = _to_numpy(leaf)
        data = _npy_bytes(arr)
        store.put_bytes(f"{prefix}/{key}.npy", data)
        leaves.append({"key": key, "shape": list(arr.shape), "dtype": dtype,
                       "bytes": len(data), "crc": hashlib.md5(data).hexdigest()})
    manifest = {"run": run, "step": step, "treedef": f"repro_torch tree of {len(leaves)} leaves",
                "leaves": leaves, "meta": extra_meta or {}}
    store.put_json(f"{prefix}/manifest.json", manifest)  # atomic rename inside
    return prefix


def checkpoint_exists(store: ObjectStore, run: str, step: int) -> bool:
    return store.exists(f"ckpt/{run}/{step}/manifest.json")


def latest_step(store: ObjectStore, run: str) -> Optional[int]:
    steps = []
    for info in store.list(f"ckpt/{run}/"):
        parts = info.key.split("/")
        if parts[-1] == "manifest.json" and len(parts) >= 3:
            try:
                steps.append(int(parts[-2]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(store: ObjectStore, run: str, step: int, like: Tree, *,
                       strict_crc: bool = True, device=None) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``like`` (reference layout; tensor
    leaves, ``meta`` ones will do, give shape and dtype, an ``int`` leaf
    restores an int), on ``device``."""
    device = resolve_device(device)
    prefix = f"ckpt/{run}/{step}"
    manifest = store.get_json(f"{prefix}/manifest.json")
    by_key = {entry["key"]: entry for entry in manifest["leaves"]}

    def load(path, leaf):
        key = _leaf_key(path)
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        data = store.get_bytes(f"{prefix}/{key}.npy")
        if strict_crc and hashlib.md5(data).hexdigest() != by_key[key]["crc"]:
            raise IOError(f"checksum mismatch for {key!r}")
        arr = np.load(io.BytesIO(data), allow_pickle=False)
        if isinstance(leaf, int):
            return int(arr)
        if arr.dtype.kind == "V":
            if by_key[key]["dtype"] != "bfloat16" or arr.dtype.itemsize != 2:
                raise TypeError(f"{key}: stored dtype {by_key[key]['dtype']} is not readable")
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != expected {tuple(leaf.shape)}")
        return t.to(device=device, dtype=leaf.dtype)

    return tree_map_with_path(load, like), manifest["meta"]


def save_state(store: ObjectStore, run: str, step: int, tree: Tree, *,
               extra_meta: Optional[Dict] = None) -> str:
    """Save a port tree (parameters or optimizer state) in the reference's
    layout."""
    return save_checkpoint(store, run, step, to_reference_layout(tree), extra_meta=extra_meta)


def restore_state(store: ObjectStore, run: str, step: int, like: Tree, *,
                  device=None) -> Tuple[Tree, Dict]:
    """Restore a port tree shaped like ``like`` (port layout)."""
    tree, meta = restore_checkpoint(store, run, step, to_reference_layout(like), device=device)
    return from_reference_layout(tree), meta
