"""Mamba2's SSD within-chunk term: the wrapper around the hand-written
Hopper kernel ``csrc/ssd.cu`` and its plain PyTorch version.

Counterpart of the reference package's ``kernels/ssd.py``
(``ssd_chunk_pallas``).  For each ``(batch, chunk)`` and head, over the
chunk's ``q`` positions::

    Y_diag[i,h,p] = sum_{j<=i} C_i.B_j * exp(cum_i,h - cum_j,h) * dt_j,h * x_j,h,p
    state[h,p,n]  = sum_j exp(cum_end,h - cum_j,h) * dt_j,h * x_j,h,p * B_j,n

with ``cum`` the running sum of ``dA`` over the chunk.  Inputs: ``x``
``(b, nc, q, h, p)``, ``dA``/``dt`` ``(b, nc, q, h)`` float32, ``B``/``C``
``(b, nc, q, n)``; ``x``, ``B`` and ``C`` float32 or bfloat16 (one type).
Outputs ``Y_diag`` ``(b, nc, q, h, p)`` and ``states`` ``(b, nc, h, p,
n)``, both float32.  The plain version
upcasts at load and takes every product and sum in fp32; the kernel
takes them in f32 on the tensor cores in 3xTF32 (``C.B^T`` excepted: an
in-order fp32 FMA on the CUDA cores), and in bf16 every product as
in-order fp32 FMA on the CUDA cores, the plain version's rounding bit for
bit, which mamba2's bf16 eval needs (``csrc/ssd.cu`` says why).

``cum`` is taken in the reference's rounding (:func:`blocked_cumsum`):
the reference's ``jnp.cumsum`` runs, on its CPU backend, as an in-order
sum within blocks of 16 positions plus the in-order running total of the
blocks before.  ``exp(cum_i - cum_j)`` carries any rounding difference of
``cum`` (~1e-5 at |cum| ~ 200) straight into the result, so a plain
in-order cumsum would miss the reference's 2e-5 tolerance.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  Forward only: the reference cannot differentiate its
kernel either, so training takes the plain ``ssd_chunked`` path
(``ModelRuntime.resolve_ssd``) and a backward through this op raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128  # the kernel's largest q: 8 warps of 16 rows of S = C.B^T
HEAD_DIMS = (16, 32, 64)  # p instantiations
STATE_DIMS = (16, 32, 64, 128)  # n instantiations
SMEM_LIMIT = 232_448  # bytes of shared memory one block may take on an H100
CUM_BLOCK = 16


def blocked_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 running sum of ``a`` along ``dim`` in the
    reference's rounding: positions summed in order within blocks of 16,
    each block then offset by the in-order running total of the blocks
    before it (recursively, for more than 16 blocks)."""
    a = a.float().movedim(dim, -1)
    n = a.shape[-1]
    if n <= CUM_BLOCK:
        out = a.clone()
        for k in range(1, n):
            out[..., k] = out[..., k - 1] + a[..., k]
        return out.movedim(-1, dim)
    nb = -(-n // CUM_BLOCK)
    blocks = F.pad(a, (0, nb * CUM_BLOCK - n)).reshape(*a.shape[:-1], nb, CUM_BLOCK)
    inner = blocked_cumsum(blocks, -1)
    before = blocked_cumsum(inner[..., -1], -1)
    before = torch.cat([torch.zeros_like(before[..., :1]), before[..., :-1]], dim=-1)
    out = (inner + before[..., None]).reshape(*a.shape[:-1], nb * CUM_BLOCK)[..., :n]
    return out.movedim(-1, dim)


def ssd_chunk_plain(
    x: torch.Tensor,  # (b, nc, q, h, p)
    dA: torch.Tensor,  # (b, nc, q, h)
    dt: torch.Tensor,  # (b, nc, q, h)
    B: torch.Tensor,  # (b, nc, q, n)
    C: torch.Tensor,  # (b, nc, q, n)
):
    """What the kernel computes, written as plain tensor code in the
    reference's order (``ref.ssd_chunk_reference``): ``(Y_diag, states)``,
    both float32."""
    cum = blocked_cumsum(dA, 2)  # (b, nc, q, h)
    q = x.shape[2]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, q, q, h)
    ar = torch.arange(q, device=x.device)
    tri = (ar[None, :] <= ar[:, None])[None, None, :, :, None]
    L = torch.where(tri, torch.exp(diff), torch.zeros((), device=x.device))
    scores = torch.einsum("bcin,bcjn->bcij", C.float(), B.float())
    M = scores[..., None] * L * dt.float()[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", M, x.float())
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt.float()  # (b, nc, q, h)
    s = torch.einsum("bcjhp,bcjn->bchpn", x.float() * w[..., None], B.float())
    return y, s


def head_slots(q: int, p: int, n: int, dtype: torch.dtype, block_h: int) -> int:
    """Head slots a block takes (mirrors ``csrc/ssd.cu``): one a head where
    all of the block's heads fit (short chunks: serving prefill), else two
    that the heads stream through."""
    if block_h <= 2 or _smem(q, p, n, _itemsize(dtype), block_h) <= SMEM_LIMIT:
        return block_h
    return 2


def smem_bytes(q: int, p: int, n: int, dtype: torch.dtype, block_h: int) -> int:
    """Dynamic shared memory of one block (mirrors ``csrc/ssd.cu``): q
    rounded up to 16-row tiles; B and C at n + pad elements a row (pad 8
    in bf16, 4 in f32), each head slot one head's x at p + pad and its
    running sums, dt and state weights in f32, and in bf16 S (q rows of
    q + 1 floats) and one head's x in f32 (q rows of p + 4) for the
    in-order route."""
    return _smem(q, p, n, _itemsize(dtype), head_slots(q, p, n, dtype, block_h))


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _smem(q: int, p: int, n: int, item: int, slots: int) -> int:
    pad = 4 if item == 4 else 8
    qp = -(-q // 16) * 16
    # the in-order bf16 route's S and one head's x in fp32
    in_order = qp * (qp + 1 + p + 4) * 4 if item == 2 else 0
    return qp * (2 * (n + pad) * item + slots * ((p + pad) * item + 3 * 4)) + in_order


def _check(x, dA, dt, B, C, block_h: int) -> int:
    if x.dim() != 5:
        raise ValueError(f"ssd_chunk takes x (b, nc, q, h, p), got {tuple(x.shape)}")
    b, nc, q, h, p = x.shape
    n = B.shape[-1]
    if dA.shape != (b, nc, q, h) or dt.shape != dA.shape or B.shape != (b, nc, q, n) \
            or C.shape != B.shape:
        raise ValueError(f"ssd_chunk shapes disagree: x {tuple(x.shape)}, dA {tuple(dA.shape)}, "
                         f"dt {tuple(dt.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    block_h = min(block_h, h)
    if h % block_h:
        raise ValueError(f"heads {h} must divide block_h {block_h}")
    return block_h


def _launch(x, dA, dt, B, C, block_h: int):
    if not all(t.is_cuda and t.device == x.device for t in (dA, dt, B, C)):
        raise ValueError("ssd_chunk operands must all lie on one CUDA device")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_chunk takes x, B, C in one of float32/bfloat16, got "
                        f"{x.dtype}/{B.dtype}/{C.dtype}")
    if dA.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError(f"ssd_chunk takes dA and dt in float32, got {dA.dtype}/{dt.dtype}")
    b, nc, q, h, p = x.shape
    n = B.shape[-1]
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"the SSD kernel takes chunks of 1..{MAX_CHUNK} positions, got {q}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"the SSD kernel is built for head width {HEAD_DIMS} and state "
                         f"{STATE_DIMS}, got p={p}, n={n}")
    if smem_bytes(q, p, n, x.dtype, block_h) > SMEM_LIMIT:
        raise ValueError(f"q={q}, p={p}, n={n} needs {smem_bytes(q, p, n, x.dtype, block_h)} "
                         "bytes of shared memory")
    x, dA, dt, B, C = (t.contiguous() for t in (x, dA, dt, B, C))
    y = torch.empty((b, nc, q, h, p), dtype=torch.float32, device=x.device)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, states.zero_()
    status = _build.library().ssd_chunk_fwd(
        _DTYPES[x.dtype], x.data_ptr(), dA.data_ptr(), dt.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), states.data_ptr(), b * nc, q, h, p, n, block_h,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "ssd_chunk_fwd")
    _build.count_launch(ssd_chunk)
    return y, states


class _SSDChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dA, dt, B, C, block_h):
        if all(t.device.type == "cpu" for t in (x, dA, dt, B, C)):
            return ssd_chunk_plain(x, dA, dt, B, C)
        return _launch(x, dA, dt, B, C, block_h)

    @staticmethod
    def backward(ctx, dy, ds):
        raise NotImplementedError(
            "the SSD chunk op has no backward: the reference package cannot "
            "differentiate its SSD kernel either; train with use_ssd_kernel=False"
        )


def ssd_chunk(
    x: torch.Tensor,  # (b, nc, q, h, p)
    dA: torch.Tensor,  # (b, nc, q, h) float32
    dt: torch.Tensor,  # (b, nc, q, h) float32
    B: torch.Tensor,  # (b, nc, q, n)
    C: torch.Tensor,  # (b, nc, q, n)
    *,
    block_h: int = 8,
):
    """``(Y_diag (b, nc, q, h, p), states (b, nc, h, p, n))``, float32.
    ``block_h`` heads share one block (and its ``C.B^T``); it must divide
    the head count, as in the reference."""
    block_h = _check(x, dA, dt, B, C, block_h)
    return _SSDChunk.apply(x, dA, dt, B, C, block_h)


ssd_chunk.launches = 0
