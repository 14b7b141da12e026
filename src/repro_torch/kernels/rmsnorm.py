"""Fused RMSNorm: the wrapper around the hand-written Hopper kernel
``csrc/rmsnorm.cu`` and its plain PyTorch version.

Counterpart of the reference package's ``kernels/rmsnorm.py``
(``rmsnorm_pallas``): ``x * rsqrt(mean(x^2) + eps) * w`` over the last
axis of a ``(rows, d)`` input, fp32 accumulation, cast to ``x.dtype``.
A tensor on the CPU (or the meta device: the dry run) takes the plain
version; a CUDA tensor launches the
kernel or raises.  The kernel has two paths, chosen by the C entry, which
reports the one it launched: ``one_pass`` for the widths it compiles in
with rows and ``w`` on the 16-byte grid, ``generic`` for the rest.
Launches are counted in total (``launches``) and per path
(``launches_by_path``).

The op is differentiable: :class:`_RMSNorm` runs the kernel (or the plain
version) forward and the analytic RMSNorm gradient backward, in plain
torch at fp32 (or the input's wider type).  The reference package has no
backward kernel for RMSNorm, so the port has none either; the gradient
reaches ``x`` and ``w`` on the card as on the CPU, where writing the
kernel's output through a raw pointer alone would cut the graph.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = ("one_pass", "generic")  # the C entry's `path` codes 0 and 1


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    acc = _acc_dtype(x)
    xf = x.to(acc)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.to(acc)).to(x.dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("rmsnorm operands must both lie on one CUDA device")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}/{w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm operands must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    path = ctypes.c_int(-1)
    status = _build.library().rmsnorm_fwd(
        _DTYPES[x.dtype], _DTYPES[w.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], float(eps), ctypes.byref(path),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "rmsnorm_fwd")
    _build.count_launch(rmsnorm, PATHS[path.value])
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        if _build.runs_plain(x, w):
            return rmsnorm_plain(x, w, eps)
        return _launch(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        acc = _acc_dtype(x)
        xf, wf, g = x.to(acc), w.to(acc), dy.to(acc)
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = xf * r
        gw = g * wf
        dx = r * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
        dw = (g * xhat).sum(dim=0)
        return dx.to(x.dtype), dw.to(w.dtype), None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of ``x`` ``(rows, d)`` by ``w`` ``(d,)``, differentiable in
    both."""
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (rows, d) and w (d,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    return _RMSNorm.apply(x, w, float(eps))


rmsnorm.launches = 0
rmsnorm.launches_by_path = dict.fromkeys(PATHS, 0)
