"""Flash attention over a full sequence: the wrapper around the
hand-written Hopper kernel ``csrc/flash_attention.cu`` and its plain
PyTorch version.

Counterpart of the reference package's ``kernels/flash_attention.py``
(``flash_attention_bhsd``): ``(BH, S, hd)`` inputs, scale ``1/sqrt(hd)``,
causal ``k_pos <= q_pos`` and sliding window ``k_pos > q_pos - window``
(positions from 0), fp32 softmax and accumulation, output in q's dtype.
The reference's ``block_q``/``block_k`` contract is kept: each sequence
length must divide ``min(block, S)``, or the call raises ``ValueError``
as the reference does; the CUDA kernel picks its own tiles.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  Both run forward only: the reference cannot
differentiate its kernel either (``jax.grad`` through its
``pallas_call`` fails), so training takes ``attn_impl`` ``direct`` or
``chunked`` in both packages, and a backward through this op raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 192)  # the kernel's instantiations


def supports(seq_len: int, head_dim: int, block: int = 512) -> bool:
    """Whether the kernel takes a causal self-attention of this length and
    head width with the default blocks."""
    return head_dim in HEAD_DIMS and seq_len % min(block, seq_len) == 0


def flash_attention_bhsd_plain(
    q: torch.Tensor,  # (BH, Sq, hd)
    k: torch.Tensor,  # (BH, Skv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Masked softmax attention in fp32, written as plain tensor code: what
    the kernel computes.  A query with nothing to attend gets zeros."""
    sq, hd = q.shape[1], q.shape[2]
    skv = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1) * mask
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, on 16-byte-aligned storage (the kernels read rows with
    16-byte loads); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    if not all(t.is_cuda and t.device == q.device for t in (k, v)):
        raise ValueError("flash attention operands must all lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    bh, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel is built for head_dim {HEAD_DIMS}, got {hd}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    status = _build.library().flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, sq, k.shape[1], hd, int(causal), int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention_fwd")
    _build.count_launch(flash_attention_bhsd)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if all(t.device.type == "cpu" for t in (q, k, v)):
            return flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "flash attention has no backward: the reference package cannot "
            "differentiate its flash kernel either; train with attn_impl='direct' "
            "or 'chunked'"
        )


def flash_attention_bhsd(
    q: torch.Tensor,  # (BH, Sq, hd)
    k: torch.Tensor,  # (BH, Skv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:  # (BH, Sq, hd), q's dtype
    if q.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash attention takes q (BH, Sq, hd) and k, v (BH, Skv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    sq, skv = q.shape[1], k.shape[1]
    block_q, block_k = min(block_q, sq), min(block_k, skv)
    if sq % block_q or skv % block_k:
        raise ValueError(f"seq ({sq},{skv}) must divide blocks ({block_q},{block_k})")
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))


flash_attention_bhsd.launches = 0
