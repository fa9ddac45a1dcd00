"""The Sobol kernel's word recurrence (``csrc/run_loop.cu``) in its CPU
twin, ``cuda_engine.sobol_words_recurrence``, against the per-position
fold: the port's byte-table fold (``_sobol_words``, the plain month loop's
draw), ``xor_fold`` and the JAX package's ``sobol_bits`` /
``sobol_bits64``, bit for bit, on the same direction tables and shifts.

The kernel holds K consecutive paths a thread and 32 runs a warp: each
month it folds a warp's first position, scans the runs' step XORs across
the lanes and steps inside each run, word(i) = word(i-1) ^ dir[t][ctz(i)].
The cases are the recurrence's edges: offsets that are not a multiple of
K, a carry into the high word inside a run (2^32 - 3), positions near
2^62, a chunk whose valid paths are not a multiple of K at a nonzero tile
offset, and the 32-bit ids' wrap at 2^32 between the tiles of a chunk at
tile0 = 2^19 - 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_torch.ops import sobol
from stock_market_monte_carlo_tpu.ops import sobol as js

MONTHS = 3
OFFSETS = (0, 3, 777, (1 << 32) - 3, (1 << 33) + 777, (1 << 62) - (1 << 20))
RUNS = (4, 8, 16)
# (tile0, valid): a ragged chunk of 2 tiles, and one of 3
CHUNKS = ((5, 8192 + 3), (37, 2 * 8192 + 1001))
WRAP_TILE0 = (1 << 19) - 1


def _operands(index_offset):
    """(direction, shift): the 64-column table for a nonzero offset, as
    the models build it, else the 32-column one; a shift made with
    numpy."""
    direction = (sobol.direction_numbers_hi32(MONTHS) if index_offset
                 else sobol.direction_numbers(MONTHS))
    shift = np.random.default_rng(index_offset % 1000).integers(
        0, 1 << 32, MONTHS, dtype=np.uint64).astype(np.uint32)
    return direction, shift


def _gid(tile0, valid):
    return (tile0 * ce.TILE_PATHS + torch.arange(valid)) & ce.MASK32


def _jax_words(direction, shift, index_offset, gid):
    """(valid, MONTHS) shifted words from the JAX package's fold."""
    idx = index_offset + gid.numpy().astype(np.uint64)
    if direction.shape[1] == 32:
        bits = js.sobol_bits(jnp.asarray(direction),
                             jnp.asarray(idx.astype(np.uint32)))
    else:
        lo = (idx & ce.MASK32).astype(np.uint32)
        hi = (idx >> 32).astype(np.uint32)
        bits = js.sobol_bits64(jnp.asarray(direction), jnp.asarray(lo),
                               jnp.asarray(hi))
    return np.asarray(bits) ^ shift


def _assert_recurrence_is_the_fold(index_offset, k, tile0, valid):
    direction, shift = _operands(index_offset)
    gid = _gid(tile0, valid)
    twin = ce.sobol_words_recurrence(direction, shift, index_offset, gid, k)
    plain = ce._sobol_words(direction, shift, index_offset, gid)
    idx = index_offset + gid
    folded = ce.xor_fold(direction, idx ^ (idx >> 1)) ^ ce._as_u32(shift)
    jax_words = _jax_words(direction, shift, index_offset, gid)
    for t in range(MONTHS):
        got = twin(t)
        assert got.shape == (valid,)
        assert torch.equal(got, plain(t))
        assert torch.equal(got, folded[:, t])
        np.testing.assert_array_equal(got.numpy(),
                                      jax_words[:, t].astype(np.int64))


@pytest.mark.parametrize("tile0,valid", CHUNKS)
@pytest.mark.parametrize("k", RUNS)
@pytest.mark.parametrize("index_offset", OFFSETS)
def test_recurrence_equals_the_fold(index_offset, k, tile0, valid):
    _assert_recurrence_is_the_fold(index_offset, k, tile0, valid)


@pytest.mark.parametrize("k", RUNS)
def test_recurrence_across_the_32bit_wrap(k):
    """32-bit positions (index_offset 0, the 32-column table): the chunk's
    second tile wraps to ids 0 .. 8191; the recurrence never steps across
    the wrap, and lane 31's step to 2^32 stays in the row."""
    gid = _gid(WRAP_TILE0, 2 * ce.TILE_PATHS)
    assert int(gid[ce.TILE_PATHS - 1]) == ce.MASK32 and int(
        gid[ce.TILE_PATHS]) == 0
    _assert_recurrence_is_the_fold(0, k, WRAP_TILE0, 2 * ce.TILE_PATHS)


def test_recurrence_refuses_a_warp_across_a_jump():
    direction, shift = _operands(0)
    gid = torch.cat([torch.arange(100), torch.arange(1000, 1156)])
    with pytest.raises(ValueError, match="consecutive"):
        ce.sobol_words_recurrence(direction, shift, 0, gid, 8)
