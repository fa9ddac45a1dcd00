"""The arithmetic counter stream, in plain PyTorch.

Frozen copy of ``_mul32``, ``_finalize``, ``_tile_seed_i32``,
``_u23_from_bits``, ``_erfinv_poly``, ``_normal_z``, ``gaussian_ab``,
``_bootstrap_idx_exact_i32``, ``_pad_table``, ``key_seed_base`` and the
counter words of ``month_growth`` from
``stock_market_monte_carlo_torch/ops/cuda_engine.py`` at commit b0a87fd,
with the seed's stream base of ``engine._segment_base`` (segment 0:
``threefry.key(seed)`` is the pair (0, seed mod 2^32)). Nothing here
imports the port. The draws that map its words to growth factors are
``reference/draws/<draw>.py``, one a configuration's ``model.draw``.

uint32 values live in int64 tensors and every product is masked to 32
bits, so the arithmetic is exact on any device.
"""

from __future__ import annotations

import numpy as np
import torch

TILE_ROWS = 64
TILE_PATHS = TILE_ROWS * 128
MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_SEED_MUL = 0x6C62272E

_SQRT2 = float(np.float32(1.4142135623730951))
_U23 = float(2.0**-23)
_ERFINV_P0 = 2.81022636e-08
_ERFINV_P = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
             0.00021858087, -0.00125372503, -0.00417768164,
             0.246640727, 1.50140941)
_ERFINV_Q0 = -0.000200214257
_ERFINV_Q = (0.000100950558, 0.00134934322, -0.00367342844,
             0.00573950773, -0.0076224613, 0.00943887047,
             1.00167406, 2.83297682)


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def seed_base(seed: int) -> int:
    """uint32 stream base of a run's seed: k0 ^ (k1 * 0x6C62272E) of the
    key (0, seed mod 2^32)."""
    return ((int(seed) & MASK32) * _SEED_MUL) & MASK32


def mul32(x, c: int):
    """Low 32 bits of x * c for uint32 ``x`` and a uint32 constant ``c``."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def finalize(x):
    """The 32-bit finalizer at the tail of the stream's hash."""
    x = mul32(x ^ (x >> 16), _MIX1)
    x = mul32(x ^ (x >> 13), _MIX2)
    return x ^ (x >> 16)


def tile_seed(base, tile):
    """Key of tile ``tile`` (or of draw ``tile`` under a tile's key)."""
    return finalize(mul32(base, _GOLDEN) ^ tile)


def u23(bits):
    """Top 23 bits -> (cnt + 0.5) * 2^-23, strictly inside (0, 1)."""
    return ((bits >> 9).to(torch.float32) + 0.5) * _U23


def erfinv_poly(x):
    """Branch-free single-precision erfinv."""
    w = -torch.log1p(-(x * x))
    wc = w - 2.5
    p = f32(_ERFINV_P0) * wc + f32(_ERFINV_P[0])
    for c in _ERFINV_P[1:]:
        p = p * wc + f32(c)
    wt = torch.sqrt(w) - 3.0
    q = f32(_ERFINV_Q0) * wt + f32(_ERFINV_Q[0])
    for c in _ERFINV_Q[1:]:
        q = q * wt + f32(c)
    return torch.where(w < 5.0, p, q) * x


def normal_z(bits):
    """z = sqrt(2) * erfinv(2u - 1) of a word."""
    return _SQRT2 * erfinv_poly(2.0 * u23(bits) - 1.0)


def gaussian_ab(mean_pct, std_pct):
    """Growth = a + b*z: a = 1 + mean*0.01, b = std*0.01, in float32."""
    f = np.float32
    return (float(f(1.0) + f(mean_pct) * f(0.01)),
            float(f(std_pct) * f(0.01)))


def idx_exact(st, n):
    """floor(n * u32 / 2^32) by a 16-bit split (exact for n < 2^15)."""
    h = st >> 16
    lo = st & 0xFFFF
    return (n * h + ((n * lo) >> 16)) >> 16


def pad_table(returns_pct):
    """(C*128,) float32 growth table (100 + r) * 0.01, zero padded, and
    its length n."""
    r = np.asarray(returns_pct, np.float32)
    n = r.shape[0]
    flat = np.zeros((-(-n // 128) * 128,), np.float32)
    flat[:n] = (np.float32(100.0) + r) * np.float32(0.01)
    return flat, n


def month_words(base: int, tile0: int, n_tiles: int, device):
    """``words(t)``: the (n_tiles, 64, 128) uint32 words of month t for
    tiles tile0 .. tile0 + n_tiles - 1 under stream ``base``, one a
    path."""
    tiles = (int(tile0) + torch.arange(n_tiles, device=device)) & MASK32
    seeds = tile_seed(int(base) & MASK32, tiles)
    pos = torch.arange(TILE_PATHS, device=device).reshape(TILE_ROWS, 128)
    pos_term = mul32(pos, _GOLDEN)

    def words(t):
        return finalize((tile_seed(seeds, t)[:, None, None] + pos_term)
                        & MASK32)
    return words
