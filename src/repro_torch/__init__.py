"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Laid out like ``src/repro/`` (``configs/``, ``kernels/``, ``models/``,
``serving/``) so each module's counterpart is easy to find.  The port
imports ``torch`` and never ``jax``, and nothing of ``repro``: what it
needs from framework-free modules there it keeps as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`resolve_device`); on a host without a GPU the default raises
instead of carrying on silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly
    or by default) and none is available; the CPU is used only when the
    caller names it, and ``meta`` (shapes only, nothing allocated: the dry
    run's) too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' ('meta' for shapes)")
    return dev
