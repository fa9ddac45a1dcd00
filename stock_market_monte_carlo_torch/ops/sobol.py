"""Sobol quasi-random points: the direction numbers on the host (numpy),
the gray-code fold in torch on the run's device.

Counterpart of ``stock_market_monte_carlo_tpu/ops/sobol.py``, with the same
functions and the same bits:

- Direction numbers are generated, not vendored: primitive polynomials over
  GF(2) (``primitive_polynomials``, a byte copy of the JAX package's
  ``_sobol_polys_d14.npy`` pinned by its sha256; ``_primitive_polys_of_degree``
  is the search that made it) and odd initial values from a fixed numpy
  seed. ``direction_numbers_u64`` is the 0.64 fixed-point table; the 32-bit
  and hi32 tables are its top words.
- Point i of a dimension is the XOR of its direction numbers over the set
  bits of gray(i) = i ^ (i >> 1): random access, no serial recurrence
  (``cuda_engine.xor_fold``, a byte of the gray code at a time).
- A per-seed digital shift (XOR) per dimension scrambles the points
  (``digital_shift``, on the port's threefry); a key whose data is zero
  gives the raw sequence.

uint32 words live in int64 tensors, as in ``ops/cuda_engine.py``. The
month-loop kernel's Sobol draws (``csrc/month_loop.cu``) fold the same
tables; its plain version is ``cuda_engine.month_growth``.
"""

from __future__ import annotations

import hashlib
import io
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from stock_market_monte_carlo_torch.ops import threefry
from stock_market_monte_carlo_torch.ops.cuda_engine import MASK32
from stock_market_monte_carlo_torch.ops.cuda_engine import _as_u32 as _u32
from stock_market_monte_carlo_torch.ops.cuda_engine import xor_fold

MAX_DEGREE = 14  # degrees 2..14: 1865 polynomials, up to 1866 dimensions
_M_SEED = 0x5350_4F42  # seed of the initial direction values
INDEX_BITS = 64  # sequence depth: indices below 2^62

_POLYS_PATH = (Path(__file__).resolve().parent
               / f"_sobol_polys_d{MAX_DEGREE}.npy")
# sha256 of the vendored polynomial table: it defines every Sobol stream
_POLYS_SHA256 = (
    "7a39686210145caa7018610655bdd784d340c055563cfd9c66999f66dec64e8d"
)

# ---------------------------------------------------------------------------
# GF(2) polynomial arithmetic on int bitmasks (host).
# ---------------------------------------------------------------------------


def _gf2_mulmod(a: int, b: int, p: int, d: int) -> int:
    """(a*b) mod p over GF(2), p of degree d."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> d & 1:
            a ^= p
    return r


def _gf2_powmod(a: int, e: int, p: int, d: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gf2_mulmod(r, a, p, d)
        a = _gf2_mulmod(a, a, p, d)
        e >>= 1
    return r


def _prime_factors(n: int):
    out = []
    f = 2
    while f * f <= n:
        if n % f == 0:
            out.append(f)
            while n % f == 0:
                n //= f
        f += 1
    if n > 1:
        out.append(n)
    return out


def _primitive_polys_of_degree(d: int):
    """All primitive polynomials of degree d over GF(2), as bitmasks
    (bit i = coefficient of x^i), in increasing numeric order: x has order
    exactly 2^d - 1 modulo the polynomial."""
    order = (1 << d) - 1
    cofactors = [order // q for q in _prime_factors(order)]
    out = []
    # constant term 1 and odd weight (else divisible by x or x+1)
    for mask in range((1 << d) | 1, 1 << (d + 1), 2):
        if bin(mask).count("1") % 2 == 0:
            continue
        if _gf2_powmod(2, order, mask, d) != 1:
            continue
        if any(_gf2_powmod(2, c, mask, d) == 1 for c in cofactors):
            continue
        out.append(mask)
    return out


@lru_cache(maxsize=1)
def primitive_polynomials() -> np.ndarray:
    """uint32 bitmasks of the primitive polynomials of degrees
    2..MAX_DEGREE, ordered by (degree, mask): the vendored table, checked
    against its sha256 (``_primitive_polys_of_degree`` made it)."""
    raw = _POLYS_PATH.read_bytes()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != _POLYS_SHA256:
        raise RuntimeError(
            f"{_POLYS_PATH.name} sha256 mismatch: got {digest}, expected "
            f"{_POLYS_SHA256}; the polynomial table defines the Sobol "
            "streams"
        )
    return np.load(io.BytesIO(raw))


def _poly_degree(mask: int) -> int:
    return mask.bit_length() - 1


@lru_cache(maxsize=32)
def direction_numbers_u64(dims: int) -> np.ndarray:
    """(dims, 64) uint64 direction numbers as 0.64 fixed point: entry
    [d][k] is XORed into the point when bit k of gray(index) is set
    (indices below 2^62). The top 32 bits of the first 32 entries are the
    32-bit table."""
    polys = primitive_polynomials()
    if dims - 1 > len(polys):
        raise ValueError(
            f"sobol: {dims} dims requested, only {len(polys) + 1} supported"
        )
    rng = np.random.default_rng(_M_SEED)
    nb = INDEX_BITS
    v = np.zeros((dims, nb), np.uint64)
    # dimension 0: van der Corput, m_k = 1 for all k
    v[0] = np.uint64(1) << (nb - 1 - np.arange(nb, dtype=np.uint64))
    mask64 = (1 << 64) - 1
    for dim in range(1, dims):
        p = int(polys[dim - 1])
        s = _poly_degree(p)
        # initial values: m_i odd, uniform in [1, 2^i), one draw each
        m = [int(rng.integers(0, 1 << max(i - 1, 0))) * 2 + 1
             for i in range(1, s + 1)]
        for k in range(s, nb):
            new = m[k - s] ^ (m[k - s] << s)
            for j in range(1, s):
                if (p >> (s - j)) & 1:
                    new ^= m[k - j] << j
            m.append(new & mask64)
        v[dim] = np.asarray(
            [(int(m[k]) << (nb - 1 - k)) & mask64 for k in range(nb)],
            np.uint64,
        )
    return v


@lru_cache(maxsize=32)
def direction_numbers(dims: int) -> np.ndarray:
    """(dims, 32) uint32 direction numbers (0.32 fixed point): the top 32
    bits of the first 32 columns of the 64-bit table."""
    return (direction_numbers_u64(dims)[:, :32] >> np.uint64(32)).astype(
        np.uint32)


@lru_cache(maxsize=32)
def direction_numbers_hi32(dims: int) -> np.ndarray:
    """(dims, 64) uint32: the top 32 bits of every 64-bit direction number,
    the table for 64-bit sequence indices with 32-bit words (XOR commutes
    with truncation)."""
    return (direction_numbers_u64(dims) >> np.uint64(32)).astype(np.uint32)


@lru_cache(maxsize=32)
def direction_numbers_split(dims: int):
    """((dims, 64) hi, (dims, 64) lo) uint32 words of the 64-bit direction
    numbers, the tables of full-precision float64 points."""
    v = direction_numbers_u64(dims)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


# ---------------------------------------------------------------------------
# Point generation (torch, uint32 values in int64 tensors).
# ---------------------------------------------------------------------------


def _device(*xs):
    for x in xs:
        if torch.is_tensor(x):
            return x.device
        if isinstance(x, tuple):  # a threefry key
            return x[0].device
    return torch.device("cpu")


def digital_shift(scramble_key, dims: int) -> torch.Tensor:
    """(dims,) uint32 per-dimension XOR shift: ``threefry.bits`` of the
    key; all zeros for a key whose data is zero."""
    bits = threefry.bits(scramble_key, (dims,))
    is_zero = (scramble_key[0] == 0) & (scramble_key[1] == 0)
    return torch.where(is_zero, 0, bits)


def sobol_bits(direction, index) -> torch.Tensor:
    """Raw Sobol words at sequence positions ``index``: direction (dims,
    32) uint32, index (...,) uint32 -> (..., dims)."""
    idx = _u32(index)
    return xor_fold(_u32(direction, idx.device), idx ^ (idx >> 1))


def sobol_bits64(direction_hi32, idx_lo, idx_hi) -> torch.Tensor:
    """Top 32 bits of the Sobol points at 64-bit positions (lo, hi words):
    direction_hi32 (dims, 64) -> (..., dims). For hi == 0 this is
    ``sobol_bits`` over the 32-bit table."""
    lo, hi = _u32(idx_lo), _u32(idx_hi)
    glo = lo ^ (((lo >> 1) | (hi << 31)) & MASK32)
    # the 64-bit gray code's pattern (its top bit may set the sign)
    gray = glo | ((hi ^ (hi >> 1)) << 32)
    return xor_fold(_u32(direction_hi32, lo.device), gray)


def _split_index64(index_offset: int, first_index, n: int, device=None):
    """(lo, hi) uint32 words of positions index_offset + first_index +
    [0, n), with ``first_index`` a uint32 int or scalar tensor."""
    if not 0 <= index_offset < 1 << 62:
        raise ValueError(
            f"sobol index_offset must be in [0, 2^62), got {index_offset}"
        )
    first = (first_index.to(torch.int64) if torch.is_tensor(first_index)
             else int(first_index)) & MASK32
    idx = index_offset + first + torch.arange(n, dtype=torch.int64,
                                              device=device)
    return idx & MASK32, idx >> 32


def sobol_bits_u32(direction, first_index, n: int, dims: int,
                   scramble_key=None, index_offset: int = 0) -> torch.Tensor:
    """(n, dims) scrambled Sobol words at positions first_index + [0, n)
    (plus ``index_offset``, which needs a (dims, 64) table): the integer
    form behind ``sobol_points_f32``, for exact integer maps such as the
    bootstrap index. Runs on the device of the key (or of the inputs)."""
    dev = _device(scramble_key, first_index, direction)
    direction = _u32(direction, dev)[:dims]
    if direction.shape[0] < dims:
        raise ValueError(
            f"{dims} dimensions asked of a {direction.shape[0]}-dimension "
            "direction table"
        )
    if index_offset != 0 or direction.shape[-1] == 64:
        if direction.shape[-1] != 64:
            raise ValueError(
                "index_offset beyond 0 needs a (dims, 64) direction table "
                "(ops.sobol.direction_numbers_hi32)"
            )
        lo, hi = _split_index64(index_offset, first_index, n, dev)
        bits = sobol_bits64(direction, lo, hi)
    else:
        first = (first_index.to(dev, torch.int64)
                 if torch.is_tensor(first_index) else int(first_index))
        idx = (first + torch.arange(n, dtype=torch.int64, device=dev)
               ) & MASK32
        bits = sobol_bits(direction, idx)
    if scramble_key is not None:
        bits = bits ^ digital_shift(scramble_key, dims)[None, :]
    return bits


def sobol_points_f32(direction, first_index, n: int, dims: int,
                     scramble_key=None, index_offset: int = 0):
    """(n, dims) float32 scrambled Sobol points in [0, 1): word * 2^-32,
    clamped below 1 (words within 128 of 2^32 round up to 1.0 in the
    conversion)."""
    bits = sobol_bits_u32(direction, first_index, n, dims, scramble_key,
                          index_offset)
    pts = bits.to(torch.float32) * float(np.float32(2.3283064365386963e-10))
    return torch.clamp_max(pts, float(np.float32(1.0 - 2.0**-24)))


def sobol_bits64_pair(dir_hi, dir_lo, idx_lo, idx_hi):
    """((..., dims) hi, (..., dims) lo) words of the full 0.64 Sobol
    integers at 64-bit positions: the fold of ``sobol_bits64`` in two
    carry-free words."""
    return (sobol_bits64(dir_hi, idx_lo, idx_hi),
            sobol_bits64(dir_lo, idx_lo, idx_hi))


def sobol_points_f64(dims: int, first_index, n: int, scramble_key=None,
                     index_offset: int = 0, device=None):
    """(n, dims) float64 Sobol points at full 64-bit precision, on
    ``device`` (default: the key's): (hi * 2^32 + lo) * 2^-64, clamped
    below 1, bit for bit ``sobol_points_f64_host`` when unscrambled. The
    64-bit shift takes one word per half, the low one from
    ``fold_in(scramble_key, 0x64)``."""
    dev = device or _device(scramble_key, first_index)
    dir_hi, dir_lo = direction_numbers_split(dims)
    lo, hi = _split_index64(index_offset, first_index, n, dev)
    acc_h, acc_l = sobol_bits64_pair(_u32(dir_hi, dev), _u32(dir_lo, dev),
                                     lo, hi)
    if scramble_key is not None:
        is_zero = (scramble_key[0] == 0) & (scramble_key[1] == 0)
        sh = threefry.bits(scramble_key, (dims,))
        sl = threefry.bits(threefry.fold_in(scramble_key, 0x64), (dims,))
        acc_h = acc_h ^ torch.where(is_zero, 0, sh).to(dev)[None, :]
        acc_l = acc_l ^ torch.where(is_zero, 0, sl).to(dev)[None, :]
    out = (acc_h.double() * 2.0**32 + acc_l.double()) * 2.0**-64
    return torch.clamp_max(out, 1.0 - 2.0**-53)


def sobol_points_f64_host(dims: int, offset: int, n: int) -> np.ndarray:
    """(n, dims) float64 points at full 64-bit precision, numpy."""
    v = direction_numbers_u64(dims)
    idx = np.arange(offset, offset + n, dtype=np.uint64)
    gray = idx ^ (idx >> np.uint64(1))
    acc = np.zeros((n, dims), np.uint64)
    for b in range(INDEX_BITS):
        take = (gray >> np.uint64(b)) & np.uint64(1)
        acc ^= np.where(take[:, None].astype(bool), v[None, :, b], 0)
    out = acc.astype(np.float64) * (2.0 ** -64)
    return np.minimum(out, 1.0 - 2.0**-53)


# Bratley-Fox "favorable" starting-seed exponents (Algorithm 659, ACM TOMS
# 14(1)), dimensions 1..13.
_TAU_TABLE = (0, 0, 1, 3, 5, 8, 11, 15, 19, 23, 27, 31, 35)


def tau_sobol(dim_num: int) -> int:
    """Favorable starting-seed exponent TAU of a ``dim_num``-dimensional
    sequence, or -1 outside the table's 1..13."""
    if 1 <= dim_num <= len(_TAU_TABLE):
        return _TAU_TABLE[dim_num - 1]
    return -1


def favorable_index_offset(dim_num: int) -> int:
    """The smallest favorable start N = 2**(TAU + dim_num - 1), for a
    model's ``index_offset``, or 0 where the table has no entry."""
    tau = tau_sobol(dim_num)
    if tau < 0:
        return 0
    return 1 << (tau + dim_num - 1)
