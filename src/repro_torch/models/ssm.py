"""Mamba2 blocks through the SSD (state-space duality) chunked algorithm.

Counterpart of the reference package's ``models/ssm.py``.  The full
sequence and prefill run the chunked SSD ("Transformers are SSMs",
arXiv:2405.21060, Listing 1): a within-chunk quadratic term plus an
inter-chunk linear recurrence over per-chunk states.  Decode runs the
O(1) recurrent update.  :func:`ssd_chunked` is the plain path and the
oracle of ``kernels.ops.ssd`` (the Hopper within-chunk kernel plus plain
glue), which the model takes when ``use_kernel`` is set.

The reference's rounding points are kept: ``causal_conv`` applies SiLU
in fp32 before the cast, ``y + D*x`` is added in y's dtype,
:func:`ssd_chunked` returns y in x's dtype and the state in fp32, and the
running sums of ``dA`` are taken as the reference takes them
(``kernels.ssd.blocked_cumsum``).  The reference's five-operand einsums
are written as explicit steps, the ones of its ``kernels/ref.py``.

Prefill differs from the reference in one place, by the port's choice:
:func:`apply_mamba2_prefill` with ``use_kernel`` runs
``ops.ssd(..., initial_state=...)`` (the reference's prefill calls
``ssd_chunked``; its ``ops.ssd`` takes ``initial_state`` and computes the
same function), so serving prefill on the card goes through the kernel.

Layouts (one state group, as in mamba2-1.3b): x ``(b, l, h, p)``, dt
``(b, l, h)`` after softplus, A ``(h,)`` negative, B and C ``(b, l, n)``.
The input projection is kept as separate matrices (w_z, w_x, w_B, w_C,
w_dt) and x, B, C are convolved separately, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd import blocked_cumsum, ssd_on_mesh
from repro_torch.models.layers import rmsnorm_gated
from repro_torch.sharding.logical import shard, unflatten_last

Params = Dict[str, torch.Tensor]
FP32_PARAMS = ("A_log", "D", "dt_bias")  # float32 in every model dtype, as in the reference


# --------------------------------------------------------------------- SSD core
def segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: ``out[..., i, j] = sum_{j < k <= i} a[..., k]``,
    ``-inf`` above the diagonal (the masked decay matrix in log space)."""
    l = a.shape[-1]
    cum = blocked_cumsum(a, -1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: ``(y (b, l, h, p) in x's dtype, final state
    (b, h, p, n) float32)``."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"seq len {l} not divisible by chunk {chunk}")
    c = l // chunk

    dA = dt * A  # (b, l, h), log space, negative
    xr = x.reshape(b, c, chunk, h, p).float()
    dtr = dt.reshape(b, c, chunk, h).float()
    dAr = dA.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b, h, c, q)
    Br = B.reshape(b, c, chunk, n).float()
    Cr = C.reshape(b, c, chunk, n).float()

    A_cumsum = blocked_cumsum(dAr, -1)  # (b, h, c, q)

    # 1. within-chunk ("diagonal") term
    L = torch.exp(segsum(dAr)).permute(0, 2, 3, 4, 1)  # (b, c, q, k, h)
    scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    M = scores[..., None] * L * dtr[:, :, None, :, :]  # (b, c, q, k, h)
    Y_diag = torch.einsum("bcqkh,bckhp->bcqhp", M, xr)

    # 2. per-chunk states: decay from each position to the chunk end
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum).permute(0, 2, 3, 1)  # (b, c, q, h)
    w = decay_states * dtr
    states = torch.einsum("bckhp,bckn->bchpn", xr * w[..., None], Br)

    # 3. inter-chunk recurrence over the chunk states
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    chunk_decay = torch.exp(A_cumsum[..., -1])  # (b, h, c)
    carry = initial_state.float()
    prev = []
    for i in range(c):
        prev.append(carry)  # the state entering chunk i
        carry = carry * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # (b, c, h, p, n)

    # 4. state -> output within each chunk
    state_decay_out = torch.exp(A_cumsum).permute(0, 2, 3, 1)  # (b, c, q, h)
    Y_off = torch.einsum("bcqn,bchpn->bcqhp", Cr, prev_states) * state_decay_out[..., None]

    y = (Y_diag + Y_off).reshape(b, l, h, p).to(x.dtype)
    return y, carry


def ssd_decode_step(
    state: torch.Tensor,  # (b, h, p, n) float32
    x: torch.Tensor,  # (b, h, p)
    dt: torch.Tensor,  # (b, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, n)
    C: torch.Tensor,  # (b, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent update: ``h' = exp(dt*A) h + dt * x (x) B``;
    ``y = C . h'``."""
    decay = torch.exp(dt * A)  # (b, h)
    upd = (dt[:, :, None] * x.float())[..., None] * B.float()[:, None, None, :]
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    return y.to(x.dtype), new_state


# ------------------------------------------------------------------- mamba2 block
def mamba2_param_tree(cfg: ArchConfig, normal, const, fp32, depth_scale: float) -> Params:
    """One mixer's parameters with the reference's shapes and scales, each
    leaf made by ``normal(shape, std)``, ``const(shape, value)`` (model
    dtype) or ``fp32(array)`` (float32) in a fixed order."""
    d, di, n, h, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv

    def dense(d_in, d_out, scale=1.0):
        return normal((d_in, d_out), scale / math.sqrt(d_in))

    def conv(c):
        return {"w": normal((k, c), 0.1), "b": const((c,), 0.0)}

    return {
        "w_z": dense(d, di),
        "w_x": dense(d, di),
        "w_B": dense(d, n),
        "w_C": dense(d, n),
        "w_dt": dense(d, h),
        "conv_x": conv(di),
        "conv_B": conv(n),
        "conv_C": conv(n),
        "A_log": fp32(np.log(np.linspace(1.0, 16.0, h, dtype=np.float32))),
        "D": fp32(np.ones((h,), np.float32)),
        "dt_bias": fp32(np.zeros((h,), np.float32)),
        "norm_w": {"w": const((di,), 1.0)},
        "out_proj": dense(di, d, depth_scale),
    }


def causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d over ``(b, l, c)`` with kernel ``(k, c)``,
    then SiLU (in fp32, cast after)."""
    k = w.shape[0]
    pad = F.pad(xc, (0, 0, k - 1, 0))
    acc = torch.zeros_like(xc, dtype=torch.float32)
    for i in range(k):
        acc = acc + pad[:, i:i + xc.shape[1], :].float() * w[i].float()
    return F.silu(acc + b.float()).to(xc.dtype)


def _project(p: Params, x: torch.Tensor):
    """x ``(b, l, d)`` -> z ``(b, l, di)``, xi/B/C before the conv, dt
    logits ``(b, l, h)``."""
    z = shard(x @ p["w_z"], "batch", "seq", "ssm_inner")
    xi = shard(x @ p["w_x"], "batch", "seq", "ssm_inner")
    return z, xi, x @ p["w_B"], x @ p["w_C"], x @ p["w_dt"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` takes it (``logaddexp(x,
    0)``, no linear cut-off)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssd(use_kernel: bool, *args, chunk: int, initial_state=None):
    if use_kernel:
        return ops.ssd(*args, chunk=chunk, initial_state=initial_state)
    if isinstance(args[0], DTensor):  # the plain scan on each rank's rows and heads
        return ssd_on_mesh(ssd_chunked, *args, chunk=chunk, initial_state=initial_state)
    return ssd_chunked(*args, chunk=chunk, initial_state=initial_state)


def _finish(p: Params, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """``y + D*x`` (added in y's dtype), the gated norm and the output
    projection; y and xh carry the heads on their last two axes."""
    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(*y.shape[:-2], cfg.d_inner)
    return rmsnorm_gated(p["norm_w"], y, z, cfg.norm_eps) @ p["out_proj"]


def apply_mamba2(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                 use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence mamba2 block (training, eval, prefill forward)."""
    b, l, _ = x.shape
    h, hp = cfg.ssm_nheads, cfg.ssm_headdim
    z, xi, B, C, dt = _project(p, x)
    xi = causal_conv(xi, p["conv_x"]["w"], p["conv_x"]["b"])
    B = causal_conv(B, p["conv_B"]["w"], p["conv_B"]["b"])
    C = causal_conv(C, p["conv_C"]["w"], p["conv_C"]["b"])
    dt = softplus(dt.float() + p["dt_bias"])  # (b, l, h)
    A = -torch.exp(p["A_log"])
    xh = shard(unflatten_last(xi, h, hp), "batch", "seq", "ssm_heads", None)
    y, _ = _ssd(use_kernel, xh, dt, A, B, C, chunk=cfg.ssm_chunk)
    return shard(_finish(p, y, xh, z, cfg), "batch", "residual_seq", "embed")


def mamba2_decode_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                        device=None) -> Dict[str, torch.Tensor]:
    """One layer's recurrent state: the conv windows in the model dtype,
    the SSM state in float32 (on ``cuda`` unless ``device`` says)."""
    device = resolve_device(device)
    di, n, h, hp, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_conv
    return {
        "conv_x": torch.zeros((batch, k - 1, di), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, k - 1, n), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, k - 1, n), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, hp, n), dtype=torch.float32, device=device),
    }


def _conv_step(state_win: torch.Tensor, xt: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Rolling depthwise conv update: window ``(b, k-1, c)``, input ``(b, c)``."""
    window = torch.cat([state_win, xt[:, None, :]], dim=1)  # (b, k, c)
    acc = torch.einsum("bkc,kc->bc", window.float(), w.float())
    out = F.silu(acc + b.float()).to(xt.dtype)
    return out, window[:, 1:, :]


def _conv_extend(
    win: torch.Tensor,  # (b, k-1, c) raw inputs before the chunk
    raw: torch.Tensor,  # (b, T, c) raw chunk inputs, right-padded
    w: torch.Tensor,
    b: torch.Tensor,
    lengths: torch.Tensor,  # (b,) valid tokens per row
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over a chunk with the cached window as left
    context: ``(SiLU outputs (b, T, c), the window ending at each row's
    last valid token)``; a row with no valid token keeps its window."""
    k = w.shape[0]
    T = raw.shape[1]
    full = torch.cat([win.to(raw.dtype), raw], dim=1)  # (b, k-1+T, c)
    acc = torch.zeros(raw.shape, dtype=torch.float32, device=raw.device)
    for i in range(k):
        acc = acc + full[:, i:i + T, :].float() * w[i].float()
    out = F.silu(acc + b.float()).to(raw.dtype)
    idx = lengths.long()[:, None] + torch.arange(k - 1, device=raw.device)[None, :]
    new_win = full.gather(1, idx[..., None].expand(-1, -1, full.shape[2]))
    return out, new_win


def _ssd_prefill_chunk(T: int, target: int) -> int:
    """Largest divisor of T that is <= the configured SSD chunk."""
    for c in range(min(target, T), 0, -1):
        if T % c == 0:
            return c
    return 1


def apply_mamba2_prefill(
    p: Params,
    x: torch.Tensor,  # (b, T, d) right-padded chunk
    state: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    *,
    valid: torch.Tensor,  # (b, T) real tokens
    lengths: torch.Tensor,  # (b,) = valid.sum(1)
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked prefill from ``state``: outputs for the whole chunk and each
    row's state after its last valid token.  Padded positions get dt = 0
    (decay 1, no update), so they change nothing; their outputs are
    unused."""
    b, T, _ = x.shape
    h, hp = cfg.ssm_nheads, cfg.ssm_headdim
    z, xi, B, C, dt = _project(p, x)
    xi, new_cx = _conv_extend(state["conv_x"], xi, p["conv_x"]["w"], p["conv_x"]["b"], lengths)
    B, new_cb = _conv_extend(state["conv_B"], B, p["conv_B"]["w"], p["conv_B"]["b"], lengths)
    C, new_cc = _conv_extend(state["conv_C"], C, p["conv_C"]["w"], p["conv_C"]["b"], lengths)
    dt = softplus(dt.float() + p["dt_bias"])  # (b, T, h)
    dt = dt * valid[..., None].float()
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(b, T, h, hp)
    y, final = _ssd(use_kernel, xh, dt, A, B, C, chunk=_ssd_prefill_chunk(T, cfg.ssm_chunk),
                    initial_state=state["ssm"])
    out = _finish(p, y, xh, z, cfg)
    return out, {"conv_x": new_cx, "conv_B": new_cb, "conv_C": new_cc, "ssm": final}


def apply_mamba2_decode(
    p: Params,
    x: torch.Tensor,  # (b, 1, d)
    state: Dict[str, torch.Tensor],
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token per row through the recurrent update."""
    b = x.shape[0]
    h, hp = cfg.ssm_nheads, cfg.ssm_headdim
    z, xi, B, C, dt = (t[:, 0] for t in _project(p, x))
    xi, new_cx = _conv_step(state["conv_x"], xi, p["conv_x"]["w"], p["conv_x"]["b"])
    B, new_cb = _conv_step(state["conv_B"], B, p["conv_B"]["w"], p["conv_B"]["b"])
    C, new_cc = _conv_step(state["conv_C"], C, p["conv_C"]["w"], p["conv_C"]["b"])
    dt = softplus(dt.float() + p["dt_bias"])  # (b, h)
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(b, h, hp)
    y, new_ssm = ssd_decode_step(state["ssm"], xh, dt, A, B, C)
    out = _finish(p, y, xh, z, cfg)[:, None, :]
    return out, {"conv_x": new_cx, "conv_B": new_cb, "conv_C": new_cc, "ssm": new_ssm}
