"""The port's device helpers against their JAX twins, on the same numpy
inputs (made from a seed), bit for bit.

The JAX helpers compute in int32 with wrapping multiplies and logical
shifts; the port's plain versions compute in int64 tensors holding uint32.
Inputs include sign-bit words and values whose products wrap.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_tpu.data.loader import HOSTILE_CSV, SYNTHETIC_CSV
from stock_market_monte_carlo_tpu.data.loader import read_historical_returns
from stock_market_monte_carlo_tpu.ops import pallas_engine as pe
from stock_market_monte_carlo_torch.ops import cuda_engine as ce

_RNG = np.random.default_rng(20261016)
# sign-bit, wrap and edge words plus random ones
_EDGE = np.array([0, 1, 2, 127, 128, 0x7FFFFFFF, 0x80000000, 0x80000001,
                  0xFFFFFFFF, 0xFFFF0000, 0x0000FFFF, 0x9E3779B9],
                 np.uint32)
WORDS = np.concatenate([
    _EDGE, _RNG.integers(0, 2**32, 4096 - _EDGE.size, dtype=np.uint32),
]).view(np.int32).reshape(32, 128)


def _t(a_i32):
    """numpy int32 -> the port's int64-holding-uint32 tensor."""
    return torch.from_numpy(
        np.asarray(a_i32, np.int32).view(np.uint32).astype(np.int64))


def _i32(t):
    return t.numpy().astype(np.uint32).view(np.int32)


def test_tile_seed_matches_jax():
    seeds = WORDS[:4].ravel()
    tiles = WORDS[4:8].ravel()
    want = np.asarray(pe._tile_seed_i32(jnp.asarray(seeds),
                                        jnp.asarray(tiles)))
    np.testing.assert_array_equal(_i32(ce._tile_seed_i32(_t(seeds),
                                                         _t(tiles))), want)
    # scalar (Python int) operands, as the kernels' wrappers pass them
    for s, k in [(0, 0), (0x80000000, 7), (0xFFFFFFFF, 359)]:
        want = np.asarray(pe._tile_seed_i32(
            jnp.asarray(np.uint32(s).view(np.int32)), jnp.int32(k)))
        assert np.int32(np.uint32(ce._tile_seed_i32(s, k)).view(np.int32)) \
            == want


@pytest.mark.parametrize("seed,key", [(0, 0), (0x7FFFFFFF, 1),
                                      (0x80000000, 359), (0xFFFFFFFF, 12),
                                      (0x1234567, 0)])
def test_arith_bits_matches_jax(seed, key):
    seed_i32 = np.uint32(seed).view(np.int32)
    want = np.asarray(pe._arith_bits(jnp.int32(seed_i32), jnp.int32(key),
                                     (64, 128)))
    pos = torch.arange(64 * 128).reshape(64, 128)
    got = ce._arith_bits(seed, key, pos)
    np.testing.assert_array_equal(_i32(got), want)


def test_u23_from_bits_matches_jax():
    want = np.asarray(pe._u23_from_bits(jnp.asarray(WORDS)))
    got = ce._u23_from_bits(_t(WORDS)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() > 0.0 and got.max() < 1.0


def test_erfinv_poly_within_two_ulp_of_jax():
    """The two twins differ only in log1p's last bit (XLA's and torch's
    CPU log1p are different implementations): <= 2 ulp, tolerance stated
    by the port's spec."""
    u = ce._u23_from_bits(_t(WORDS))
    x = (2.0 * u - 1.0).numpy()
    x = np.concatenate([x.ravel(), np.float32([1 - 2**-23, -(1 - 2**-23),
                                               0.0, 0.5, -0.999])])
    want = np.asarray(pe._erfinv_poly(jnp.asarray(x)))
    got = ce._erfinv_poly(torch.from_numpy(x)).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2, ulp.max()


@pytest.mark.parametrize("n", [1, 97, 1127, 32767])
def test_bootstrap_idx_exact_matches_jax(n):
    want = np.asarray(pe._bootstrap_idx_exact_i32(jnp.asarray(WORDS),
                                                  jnp.int32(n)))
    got = ce._bootstrap_idx_exact_i32(_t(WORDS), n)
    np.testing.assert_array_equal(_i32(got), want)
    assert want.min() >= 0 and want.max() < n
    # per-lane n, as the source role passes it
    lanes = np.where(np.arange(128) < 5, 9, 8).astype(np.int32)
    want = np.asarray(pe._bootstrap_idx_exact_i32(jnp.asarray(WORDS),
                                                  jnp.asarray(lanes)))
    got = ce._bootstrap_idx_exact_i32(_t(WORDS), torch.from_numpy(
        lanes.astype(np.int64)))
    np.testing.assert_array_equal(_i32(got), want)


@pytest.mark.parametrize("csv", [SYNTHETIC_CSV, HOSTILE_CSV],
                         ids=["n1127", "hostile_n97"])
def test_sliced_rotation_draw_matches_jax(csv):
    returns = read_historical_returns(csv)
    table2d, n = pe._pad_table(jnp.asarray(returns))
    k = int(table2d.shape[0])
    tail_n = n - 128 * (k - 1)
    shape = WORDS.shape
    rows = [jnp.broadcast_to(table2d[c, :][None, :], shape)
            for c in range(k)]
    ll = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    n_valid = jnp.where(ll < tail_n, jnp.int32(k), jnp.int32(k - 1))
    want = np.asarray(pe._sliced_rotation_draw(
        rows, ll, n_valid, jnp.int32(n), jnp.int32(tail_n), k,
        jnp.asarray(WORDS)))

    flat, n_port = ce._pad_table(returns)
    assert n_port == n
    np.testing.assert_array_equal(flat, np.asarray(table2d).ravel())
    lane = torch.arange(128)
    got = ce._sliced_rotation_draw(
        torch.from_numpy(flat).reshape(k, 128),
        torch.where(lane < tail_n, k, k - 1), n, tail_n, _t(WORDS))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want > 0.0)  # padding is never selected


def test_kernel_bin_indices_match_jax():
    vals = np.exp(_RNG.normal(np.log(1000.0), 1.5, 4096)).astype(np.float32)
    vals[:6] = [0.0, 1e-38, 5e3, np.inf, 3e38, 1.0]
    mask = np.arange(vals.size) % 17 != 9
    log_lo, inv_w, hb = np.float32(np.log(50.0)), np.float32(410.3), 4096
    want = np.asarray(pe._kernel_bin_indices(
        jnp.asarray(vals), jnp.asarray(mask), jnp.float32(log_lo),
        jnp.float32(inv_w), hb))
    got = ce._kernel_bin_indices(
        torch.from_numpy(vals), torch.from_numpy(mask), float(log_lo),
        float(inv_w), hb)
    got = got.numpy()
    finite = np.isfinite(vals)
    np.testing.assert_array_equal(got[finite], want[finite])
    # +inf: the port clamps the float before the cast and files it in the
    # overflow cell; JAX's int cast of inf overflows and its clip files it
    # in cell 1 (ROADMAP queue 3). 3e38 is finite and agrees.
    assert got[3] == hb - 1 and got[4] == hb - 1


@pytest.mark.parametrize("seed", [0, 1, 12, 2**31 - 1, 2**32 - 1])
def test_seed_base_matches_jax(seed):
    from stock_market_monte_carlo_torch.engine import engine as port_engine

    want = np.asarray(pe._seed_base_i32(jax.random.key(seed)))
    assert port_engine._segment_base(seed, 0) == int(want.view(np.uint32))


@pytest.mark.parametrize("name", ["sp500_monthly_returns_synthetic.csv",
                                  "hostile_monthly_returns.csv"])
def test_port_data_tables_are_byte_copies(name):
    """The port reads its own copies of the vendored tables, byte for byte
    the JAX package's, and parses them as the JAX loader does."""
    from stock_market_monte_carlo_torch.data import loader as port_loader

    port_path = os.path.join(os.path.dirname(port_loader.__file__), name)
    jax_path = os.path.join(os.path.dirname(SYNTHETIC_CSV), name)
    assert port_path in (port_loader.SYNTHETIC_CSV, port_loader.HOSTILE_CSV)
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(
        port_loader.read_historical_returns(port_path),
        read_historical_returns(jax_path))
