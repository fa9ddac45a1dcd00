"""The ``jax.random`` functions on the threefry stream that the JAX
package's XLA paths call, in plain PyTorch.

The JAX package draws trajectories (``engine.sample_growth``, reached from
``simulate_paths`` and from ``simulate_bands`` under a fixed-amount
strategy) with one ``jax.random.fold_in`` key per 8192-path tile, and keys
its seed segments and scramble key with ``fold_in`` too. This module
reproduces those functions bit for bit:

- ``key(seed)``: the key data ``[0, seed mod 2^32]`` of
  ``jax.random.key(seed)`` (64-bit mode off, seeds in int32 or uint32
  range);
- ``fold_in``, ``split``: threefry2x32 of the key over ``(0, data)``
  (``jax_threefry_partitionable`` is on, so ``split`` is fold-like);
- ``bits``: the partitionable layout, element ``i`` of the flat shape is
  ``y0 ^ y1`` of threefry2x32 over ``(i >> 32, i & 0xFFFFFFFF)``;
- ``uniform``, ``normal`` and ``randint``, as ``jax.random`` derives them
  from the bits.

A key is a pair ``(k0, k1)`` of int64 tensors of one batch shape (uint32
values); every function broadcasts over that batch, so one call draws for
many tile keys. uint32 arithmetic runs in int64 tensors with every sum
masked to 32 bits (threefry needs no multiply). The functions run on the
device of the key tensors: plain torch on the card, as the JAX package
runs them as XLA.

``normal`` uses the port's ``_erfinv_poly``, the polynomial XLA's
``erf_inv`` evaluates; on the CPU XLA contracts some of its steps into
fmas, so a normal can differ from jax's in the last bit (ROADMAP queue 3).
The integer functions (keys, bits, ``randint``) are exact.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stock_market_monte_carlo_torch.ops.cuda_engine import (
    MASK32,
    _SQRT2,
    _erfinv_poly,
    _mul32,
)

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# nextafter(-1, 0) in float32: the open lower end of normal's uniform
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (``jax._src.prng._threefry2x32``): the
    pair (x0, x1) under key (k0, k1), as int64 tensors of the operands'
    broadcast shape. All operands hold uint32 values in int64 tensors (or
    Python ints) and broadcast. The rounds update two buffers in place:
    the plain versions draw tens of millions of words a call, where a
    fresh tensor an operation costs more than the operation."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (t.clone() for t in torch.broadcast_tensors(
        torch.as_tensor((x0 + ks[0]) & MASK32),
        torch.as_tensor((x1 + ks[1]) & MASK32)))
    high = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            # x0 += x1; x1 = x0 ^ rotl(x1, r)
            x0.add_(x1).bitwise_and_(MASK32)
            torch.bitwise_left_shift(x1, r, out=high).bitwise_and_(MASK32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK32)
    return x0, x1


def key(seed: int, device=None):
    """The key data of ``jax.random.key(seed)``: ``(0, seed mod 2^32)``."""
    t = torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                     device=device)
    return t[0], t[1]


def key_data(k) -> tuple:
    """The key as Python ints ``(k0, k1)`` (one key, no batch)."""
    return int(k[0]), int(k[1])


def fold_in(k, data):
    """``jax.random.fold_in(k, data)`` for uint32 ``data`` (an int or an
    int64 tensor, broadcast against the key's batch)."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data) & MASK32, dtype=torch.int64,
                            device=k[0].device)
    return threefry2x32(k[0], k[1], torch.zeros_like(data), data)


def split(k, num: int):
    """``jax.random.split(k, num)``: keys of batch shape
    ``k.shape + (num,)``."""
    i = torch.arange(num, dtype=torch.int64, device=k[0].device)
    return threefry2x32(k[0][..., None], k[1][..., None],
                        torch.zeros_like(i), i)


def bits_at(k, counters):
    """The words of key ``k`` at the int64 ``counters`` (below 2^64):
    ``y0 ^ y1`` of threefry2x32 over (counter >> 32, counter mod 2^32),
    element ``i`` of ``jax.random.bits``'s flat layout at counter i."""
    y0, y1 = threefry2x32(k[0], k[1], counters >> 32, counters & MASK32)
    return y0 ^ y1


def bits(k, shape):
    """``jax.random.bits(k, shape)`` (uint32) as int64: batch + shape."""
    shape = tuple(shape)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=k[0].device)
    return bits_at((k[0][..., None], k[1][..., None]), i).reshape(
        k[0].shape + shape)


def _unit_floats(b):
    """[0, 1) float32 from the top 23 bits: bitcast(b >> 9 | 1.0) - 1."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_of_bits(b, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform``'s float32 values of the words ``b``."""
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(lo))
    return torch.clamp_min(_unit_floats(b) * span + lo, lo)


def uniform(k, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    return uniform_of_bits(bits(k, shape), minval, maxval)


def normal_of_bits(b):
    """``jax.random.normal``'s float32 values of the words ``b``:
    sqrt(2) * erfinv(u) with u uniform in (-1, 1)."""
    return _SQRT2 * _erfinv_poly(uniform_of_bits(b, _NORMAL_LO, 1.0))


def normal(k, shape):
    """``jax.random.normal(k, shape, float32)``."""
    return normal_of_bits(bits(k, shape))


def randint_multiplier(span: int) -> int:
    """randint's (2^32 mod span) as it computes it: ((2^16 mod span)^2
    mod 2^32) mod span."""
    return (((1 << 16) % span) ** 2 & MASK32) % span


def randint_of_bits(higher, lower, span: int):
    """``jax.random.randint``'s offsets in [0, span) of its two words, from
    ``split(k, 2)[0]`` and ``[1]``: each reduced mod the span, combined as
    (hi * (2^32 mod span) + lo) mod span with uint32 wrapping."""
    offset = _mul32(higher % span, randint_multiplier(span)) + lower % span
    return (offset & MASK32) % span


def randint(k, shape, minval: int, maxval: int):
    """``jax.random.randint(k, shape, minval, maxval)`` (int32 range) as
    int64."""
    if not (-(1 << 31) <= minval and maxval <= (1 << 31) - 1):
        raise ValueError(f"randint bounds [{minval}, {maxval}) outside "
                         "int32")
    span = max(maxval - minval, 1)
    k0, k1 = split(k, 2)
    return minval + randint_of_bits(bits((k0[..., 0], k1[..., 0]), shape),
                                    bits((k0[..., 1], k1[..., 1]), shape),
                                    span)
