"""Which rounding of the SSD chunk kernel's products holds the f32 gate,
on the CPU.

    python3 tools/ssd_rounding.py [--chunks 8] [--seed 70]

The f32 SSD kernel is held on the card against its plain version at
atol = rtol = 2e-5 (``chip_smoke.py``).  The plain version takes ``C.B^T``
and ``M.x`` as fp32 fused multiply-adds in order (what the card's and the
CPU's float32 matmuls compute at these widths), and ``Y_diag`` multiplies
``S``'s rounding by ``dt x`` (up to ~20 at the reference sweep's inputs).
This script forms ``Y_diag`` at mamba2-1.3b's widths (q 128, h 64, p 64,
n 128; ``--chunks`` chunks of one row, inputs drawn as the reference's
sweep draws them) with ``S`` and ``M.x`` each taken one of four ways --
``in_order`` (fp32 FMA chains, the plain version's rounding), ``exact``
(float64), ``3xtf32`` (TF32 hi/lo split, lo.hi + hi.lo + hi.hi) -- and
prints, for each design, the largest ``|y - plain| / (2e-5 + 2e-5
|plain|)``: at most 1 passes the gate.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.ssd import blocked_cumsum  # noqa: E402


def tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def in_order(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """einsum over the second operand's contracted axis as fp32 FMA
    chains in order (each step exact in float64, rounded once)."""
    k_axis = {"S": -1, "Y": 3}[eq]
    out = None
    for k in range(a.shape[k_axis]):
        if eq == "S":
            term = a[..., :, None, k].double() * b[..., None, :, k].double()
        else:
            term = a[:, :, :, k, :, None].double() * b[:, :, None, k, :, :].double()
        out = term.float() if out is None else (out.double() + term).float()
    return out


def product(a, b, eq: str, how: str) -> torch.Tensor:
    spec = {"S": "bcin,bcjn->bcij", "Y": "bcijh,bcjhp->bcihp"}[eq]
    if how == "in_order":
        return in_order(a, b, eq)
    if how == "exact":
        return torch.einsum(spec, a.double(), b.double()).float()
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return sum(torch.einsum(spec, u.double(), v.double()) for u, v in
               ((al, bh), (ah, bl), (ah, bh))).float()


def y_diag(x, dt, A, B, C, s_how: str, y_how: str) -> torch.Tensor:
    q = x.shape[2]
    cum = blocked_cumsum(dt * A, 2)
    S = product(C, B, "S", s_how)
    ar = torch.arange(q)
    tri = (ar[None, :] <= ar[:, None])[None, None, :, :, None]
    L = torch.where(tri, torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :]),
                    torch.zeros(()))
    M = S[..., None] * L * dt[:, :, None, :, :]
    return product(M, x, "Y", y_how)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=70)
    args = ap.parse_args()
    q, h, p, n = 128, 64, 64, 128
    rng = np.random.default_rng(args.seed)
    shape = (1, args.chunks, q)
    x = torch.from_numpy(rng.standard_normal((*shape, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((*shape, h)), 0).astype(np.float32))
    A = torch.from_numpy((-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((*shape, n)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((*shape, n)).astype(np.float32))
    plain = y_diag(x, dt, A, B, C, "in_order", "in_order")
    for s_how, y_how in (("exact", "exact"), ("3xtf32", "3xtf32"), ("in_order", "exact"),
                         ("in_order", "3xtf32")):
        got = y_diag(x, dt, A, B, C, s_how, y_how)
        score = ((got - plain).abs() / (2e-5 + 2e-5 * plain.abs())).max().item()
        print(json.dumps({"S": s_how, "M.x": y_how, "elements": plain.numel(),
                          "seed": args.seed, "worst_over_gate": score}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
