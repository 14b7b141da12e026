"""``jax.random``'s threefry stream, reproduced in torch.

The reference package draws its sampling noise, its synthetic data and
its stochastic rounding from ``jax.random`` with the default
``threefry2x32`` implementation in its partitionable form
(``jax_threefry_partitionable``, on by default since jax 0.5):

- ``PRNGKey(s)`` is the pair ``(s >> 32, s & 0xFFFFFFFF)``;
- ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
- ``split(k, n)[i]`` is ``threefry2x32(k, (0, i))``;
- the 32 random bits of element ``i`` of a draw of shape ``shape`` are
  ``out0 ^ out1`` of ``threefry2x32(k, (0, i))``, ``i`` the row-major
  flat index.

The samplers (``uniform``, ``gumbel``, ``randint``, ``bernoulli``,
``normal``) then follow ``jax/_src/random.py`` step for step, so every
integer a draw produces is the reference's bit for bit; floats derived
from the bits by ``log`` agree to the last ulp of the two libraries'
``log``, and ``normal``'s, computed through XLA's single-precision
``erf_inv`` polynomial, to a few ulps (XLA's ``log1p`` is its own).

A key is an int64 tensor of shape ``(..., 2)`` holding two 32-bit words;
leading axes batch independent keys, and every function broadcasts over
them, on whatever device the key lies.  Words are kept in int64 and
masked to 32 bits after each addition and shift, which gives uint32
arithmetic with the ops every device supports.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on int64 tensors of
    32-bit words; the keys broadcast against the counters.  Returns the
    two output words."""
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
    x = x1.expand(shape).clone()
    y = x2.expand(shape).clone()
    return _threefry_(k1, k2, x, y)


def _threefry_(k1, k2, x: torch.Tensor, y: torch.Tensor):
    """``threefry2x32`` computed in place in the counter words ``x`` and
    ``y`` (full-shape int64 tensors), with one scratch tensor."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x.add_(k1).bitwise_and_(MASK)
    y.add_(k2).bitwise_and_(MASK)
    t = torch.empty_like(x)
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x.add_(y).bitwise_and_(MASK)
            torch.bitwise_left_shift(y, r, out=t)  # rotate y left by r
            t.bitwise_and_(MASK)
            y.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x)
        x.add_(ks[(block + 1) % 3]).bitwise_and_(MASK)
        y.add_(ks[(block + 2) % 3] + (block + 1)).bitwise_and_(MASK)
    return x, y


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)`` for a non-negative integer seed, on
    ``device`` (``cuda`` unless the caller names the CPU)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _words(key: torch.Tensor):
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has a trailing axis of 2 words, got shape {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` (an int or an integer tensor)
    broadcasts against the key's batch axes."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    a, b = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` keys along a new axis before the
    words, ``(..., num, 2)``."""
    k1, k2 = _words(key)
    i = torch.arange(int(num), dtype=torch.int64, device=key.device)
    a, b = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(i), i)
    return torch.stack((a, b), dim=-1)


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``, uint32), as int64
    of shape ``key.shape[:-1] + shape``.  Computed in chunks of the flat
    counter that stay in cache on the CPU and bound the scratch on a GPU."""
    shape = _shape(shape)
    k1, k2 = (w[..., None] for w in _words(key))
    n = int(np.prod(shape)) if shape else 1
    if n >= 2 ** 32:
        raise ValueError("draws of 2**32 elements or more take the high counter word")
    batch = tuple(key.shape[:-1])
    out = torch.empty(batch + (n,), dtype=torch.int64, device=key.device)
    per = (1 << 24 if key.is_cuda else 1 << 18) // max(1, int(np.prod(batch)))
    per = max(per, 1)
    for s in range(0, n, per):
        e = min(n, s + per)
        i = torch.arange(s, e, dtype=torch.int64, device=key.device)
        x, y = _threefry_(k1, k2, torch.zeros(batch + (e - s,), dtype=torch.int64,
                                              device=key.device),
                          i.expand(batch + (e - s,)).clone())
        torch.bitwise_xor(x, y, out=out[..., s:e])
    return out.reshape(batch + shape)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 in ``[minval, maxval)``: the top 23 bits become the
    mantissa of a float in ``[1, 2)``, shifted and scaled as JAX does."""
    b = bits(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    if lo == 0 and span == 1:  # [0, 1): the scale and shift are exact
        return f
    # XLA fuses f * span + lo into one rounding; in float64 the product and
    # sum are exact, so the cast rounds once as well
    x = (f.double() * float(span) + float(lo)).float()
    return torch.clamp_min(x, float(lo))


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ("low") mode, float32."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, minval=tiny, maxval=1.0)))


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for the int32 range (as int64): two bit draws
    from ``split(key)``, the high one scaled by ``2**32 % span``."""
    i32 = np.iinfo(np.int32)
    lo = min(max(int(minval), i32.min), i32.max)
    hi = min(max(int(maxval), i32.min), i32.max)
    span = (hi - lo) & MASK
    if hi <= lo:
        span = 1
    elif int(maxval) > i32.max:
        span = (span + 1) & MASK
    k = split(key, 2)
    higher, lower = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    if span == 0:  # the full 2**32 range: XLA's x % 0 is x, the multiplier wraps to 0
        offset = lower
    else:
        mult = ((2 ** 16 % span) ** 2 & MASK) % span  # uint32 product, as JAX wraps it
        offset = (((higher % span) * mult & MASK) + lower % span) & MASK
        offset = offset % span
    return ((lo + offset + 2 ** 31) & MASK) - 2 ** 31  # int32 wrap of minval + offset


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` ("low" mode, float32 ``p``): ``uniform < p``."""
    return uniform(key, shape) < float(np.float32(p))


# XLA's single-precision erf_inv (M. Giles, "Approximating the erfinv
# function"): a degree-8 polynomial in w - 2.5 for w = -log1p(-x^2) < 5,
# else in sqrt(w) - 3, times x
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` for float32 as XLA expands it: ``torch.erfinv``
    differs from it by up to ~2e-5 at the draws' tails.  Each Horner step
    is one fused multiply-add (the product and sum in float64, rounded
    once), as XLA's CPU code forms it; ``x = +-1`` gives ``+-inf``."""
    w = -torch.log1p(-x * x)
    central = w < 5
    t = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0).double()
    c = [torch.where(central, torch.tensor(a, dtype=torch.float32, device=x.device),
                     torch.tensor(b, dtype=torch.float32, device=x.device)).double()
         for a, b in zip(_ERFINV_CENTRAL, _ERFINV_TAIL)]
    p = c[0].float()
    for ci in c[1:]:
        p = (ci + p.double() * t).float()
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` for float32: ``uniform`` over
    ``[nextafter(-1, 0), 1)``, then ``sqrt(2) * erf_inv``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return float(np.float32(np.sqrt(2))) * erfinv(uniform(key, shape, minval=lo, maxval=1.0))
