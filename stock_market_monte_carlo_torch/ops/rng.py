"""The reference CUDA simulator's device generators, in torch with uint32
semantics: the reference-parity suite.

Counterpart of ``stock_market_monte_carlo_tpu/ops/rng.py`` (its parity
half; the port's counter streams are ``ops/cuda_engine.py`` and
``ops/threefry.py``). Every function takes and returns uint32 values held
in int64 tensors (or anything ``torch.as_tensor`` takes), with every
product and left shift masked to 32 bits, so right shifts are logical.

- ``pcg_hash``: the reference's ``rand_pcg``, a pure hash of its argument
  (its LCG advance acts on a copy and is dead code);
- ``xorshift_step`` (the 11/7/12 xorshift its kernels draw with),
  ``xorshift_gm_step`` (Marsaglia's 13/17/5), ``xorshf96`` (a pure hash:
  y and z restart from constants each call);
- ``taus_step``, ``lcg_step`` and the three HybridTaus generators;
- ``xorshift_stream``: the reference kernel's recipe, state0 =
  pcg_hash(lane), then one xorshift per draw;
- ``bootstrap_index_from_bits`` (the reference's float32 u32 -> row map)
  and ``bootstrap_index_exact`` (floor(n * u32 / 2^32), the exact integer
  form the reference-parity month loop uses).

``HistoricalBootstrap(rng="reference")`` draws path p's months from
``xorshift_stream(p + 1, T)`` through ``bootstrap_index_exact``, in the
month-loop kernel (``csrc/month_loop.cu``, ``kReference``) and on the
trajectory route (``sample_returns_pct_reference``).
"""

from __future__ import annotations

import numpy as np
import torch

from stock_market_monte_carlo_torch.ops.cuda_engine import (
    MASK32,
    _as_u32 as _u32,
    _bootstrap_idx_exact_i32,
    _mul32,
    _pcg_hash_i32,
    _xorshift_i32,
)

# 2^-32 in float32, the u32 -> [0,1) scale of the reference
U32_TO_UNIT = 2.3283064365386963e-10


def _shl(x, n: int):
    return (x << n) & MASK32


def uniform_from_bits(bits_u32) -> torch.Tensor:
    """u32 -> [0, 1) float32 with the reference's scale (the conversion
    rounds to 24 bits first)."""
    return _u32(bits_u32).to(torch.float32) * float(np.float32(U32_TO_UNIT))


def pcg_hash(x) -> torch.Tensor:
    """The reference's ``rand_pcg`` as a hash of ``x``."""
    return _pcg_hash_i32(_u32(x))


def xorshift_step(state):
    """One step of the reference kernels' xorshift: y ^= y<<11; y ^=
    y>>7; y ^= y>>12. Returns (new_state, draw), the draw being the
    state."""
    y = _xorshift_i32(_u32(state))
    return y, y


def xorshift_gm_step(state):
    """Marsaglia's 13/17/5 xorshift. Returns (new_state, draw)."""
    x = _u32(state)
    x = x ^ _shl(x, 13)
    x = x ^ (x >> 17)
    x = x ^ _shl(x, 5)
    return x, x


def xorshf96(x) -> torch.Tensor:
    """The reference's ``xorshf96``: with y and z restarting from their
    constants each call, a hash of x."""
    x = _u32(x)
    x = x ^ _shl(x, 16)
    x = x ^ (x >> 5)
    x = x ^ _shl(x, 1)
    return x ^ 362436069 ^ 521288629


def taus_step(z, s1: int, s2: int, s3: int, m: int) -> torch.Tensor:
    """Tausworthe component: ((z & m) << s3) ^ (((z << s1) ^ z) >> s2)."""
    z = _u32(z)
    b = (_shl(z, s1) ^ z) >> s2
    return _shl(z & m, s3) ^ b


def lcg_step(z, a: int, c: int) -> torch.Tensor:
    """LCG component: z * a + c mod 2^32."""
    return (_mul32(_u32(z), a) + c) & MASK32


def hybrid_taus_simple_step(state):
    """Two Tausworthe streams; ``state`` (..., 2). Returns (new_state,
    float32 uniform)."""
    state = _u32(state)
    z0 = taus_step(state[..., 0], 13, 19, 12, 4294967294)
    z1 = taus_step(state[..., 1], 2, 25, 4, 4294967288)
    return torch.stack([z0, z1], dim=-1), uniform_from_bits(z0 ^ z1)


def hybrid_taus_simplest_step(state):
    """One Tausworthe stream. Returns (new_state, float32 uniform)."""
    z0 = taus_step(state, 13, 19, 12, 4294967294)
    return z0, uniform_from_bits(z0)


def hybrid_taus_step(state):
    """Three Tausworthe streams XOR one LCG; ``state`` (..., 4). Returns
    (new_state, float32 uniform in [0, 1))."""
    state = _u32(state)
    z0 = taus_step(state[..., 0], 13, 19, 12, 4294967294)
    z1 = taus_step(state[..., 1], 2, 25, 4, 4294967288)
    z2 = taus_step(state[..., 2], 3, 11, 17, 4294967280)
    z3 = lcg_step(state[..., 3], 1664525, 1013904223)
    new_state = torch.stack([z0, z1, z2, z3], dim=-1)
    return new_state, uniform_from_bits(z0 ^ z1 ^ z2 ^ z3)


def xorshift_stream(seed_per_lane, n_steps: int) -> torch.Tensor:
    """``n_steps`` draws per lane, the reference kernel's recipe: state0 =
    pcg_hash(seed), then one xorshift per draw. (...,) -> (..., n_steps)."""
    state = pcg_hash(seed_per_lane)
    outs = []
    for _ in range(n_steps):
        state, out = xorshift_step(state)
        outs.append(out)
    if not outs:
        return state.new_zeros(state.shape + (0,))
    return torch.stack(outs, dim=-1)


def bootstrap_index_from_bits(bits_u32, n_table: int) -> torch.Tensor:
    """The reference's float32 u32 -> row map, int(n * (u32 * 2^-32)),
    capped at n - 1 (the conversion's 24-bit rounding moves ~1e-4 of draws
    to a neighbouring row of the exact map)."""
    u = uniform_from_bits(bits_u32)
    idx = (u * float(np.float32(n_table))).to(torch.int64)
    return torch.clamp_max(idx, n_table - 1)


def bootstrap_index_exact(bits_u32, n_table: int) -> torch.Tensor:
    """floor(n * u32 / 2^32) by a 16-bit split, exact for n < 2^15."""
    return _bootstrap_idx_exact_i32(_u32(bits_u32), int(n_table))
