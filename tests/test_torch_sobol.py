"""The port's Sobol module (``ops/sobol.py``) and inverse normal CDF
(``ops/normal.py``) against the JAX package's, on the CPU.

Host tables (polynomials, direction numbers) are compared byte for byte;
the torch functions (digital shift, the 32- and 64-bit folds, the points)
bit for bit on the same inputs, made with numpy.
"""

import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stock_market_monte_carlo_torch.ops import normal as port_normal
from stock_market_monte_carlo_torch.ops import sobol as ps
from stock_market_monte_carlo_torch.ops import threefry
from stock_market_monte_carlo_tpu.ops import normal as jax_normal
from stock_market_monte_carlo_tpu.ops import sobol as js

SEEDS = (0, 1, 12, 2**31 - 1, 2**32 - 1)


def _np(t):
    return t.cpu().numpy()


def _keys(seed):
    """(port, jax) scramble keys of ``seed``: fold_in(key(seed), 0x50B0)."""
    return (threefry.fold_in(threefry.key(seed), 0x50B0),
            jax.random.fold_in(jax.random.key(seed), 0x50B0))


def _u32(rng, shape, top=False):
    lo = 2**32 - 4096 if top else 0
    return rng.integers(lo, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------


def test_polynomial_table_is_a_pinned_byte_copy():
    port_file = Path(ps.__file__).with_name("_sobol_polys_d14.npy")
    jax_file = Path(js.__file__).with_name("_sobol_polys_d14.npy")
    raw = port_file.read_bytes()
    assert raw == jax_file.read_bytes()
    assert hashlib.sha256(raw).hexdigest() == ps._POLYS_SHA256
    polys = ps.primitive_polynomials()
    np.testing.assert_array_equal(polys, js.primitive_polynomials())
    assert polys.dtype == np.uint32
    # the search that made it, for the low degrees
    head = [p for d in range(2, 11) for p in ps._primitive_polys_of_degree(d)]
    np.testing.assert_array_equal(polys[:len(head)], head)


@pytest.mark.parametrize("dims", [1, 12, 360])
def test_direction_tables_byte_equal(dims):
    for name in ("direction_numbers_u64", "direction_numbers",
                 "direction_numbers_hi32"):
        got, want = getattr(ps, name)(dims), getattr(js, name)(dims)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for got, want in zip(ps.direction_numbers_split(dims),
                         js.direction_numbers_split(dims)):
        assert got.tobytes() == want.tobytes()


def test_direction_dims_limit():
    n = len(ps.primitive_polynomials()) + 1
    with pytest.raises(ValueError, match="dims requested"):
        ps.direction_numbers_u64(n + 1)


def test_tau_and_favorable_offset_match_jax():
    for d in range(0, 16):
        assert ps.tau_sobol(d) == js.tau_sobol(d)
        assert ps.favorable_index_offset(d) == js.favorable_index_offset(d)


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_digital_shift_matches_jax(seed):
    pk, jk = _keys(seed)
    for dims in (1, 7, 12, 360):
        got = ps.digital_shift(pk, dims)
        want = np.asarray(js.digital_shift(jk, dims))
        np.testing.assert_array_equal(_np(got), want.astype(np.int64))
    # a key whose data is zero gives the raw sequence
    zero = (torch.tensor(0), torch.tensor(0))
    assert int(ps.digital_shift(zero, 12).abs().sum()) == 0
    np.testing.assert_array_equal(
        np.asarray(js.digital_shift(jax.random.wrap_key_data(
            jnp.zeros(2, jnp.uint32)), 12)), 0)


def test_sobol_bits_match_jax():
    rng = np.random.default_rng(1)
    v = js.direction_numbers(9)
    idx = np.concatenate([np.arange(300), _u32(rng, 200),
                          _u32(rng, 20, top=True)]).astype(np.uint32)
    got = ps.sobol_bits(v, torch.as_tensor(idx.astype(np.int64)))
    want = np.asarray(js.sobol_bits(jnp.asarray(v), jnp.asarray(idx)))
    np.testing.assert_array_equal(_np(got), want.astype(np.int64))


def test_sobol_bits64_match_jax():
    rng = np.random.default_rng(2)
    v = js.direction_numbers_hi32(5)
    lo, hi = _u32(rng, 400), _u32(rng, 400)
    hi[:50] = 0
    got = ps.sobol_bits64(v, torch.as_tensor(lo.astype(np.int64)),
                          torch.as_tensor(hi.astype(np.int64)))
    want = np.asarray(js.sobol_bits64(jnp.asarray(v), jnp.asarray(lo),
                                      jnp.asarray(hi)))
    np.testing.assert_array_equal(_np(got), want.astype(np.int64))
    dh, dl = js.direction_numbers_split(5)
    got_h, got_l = ps.sobol_bits64_pair(dh, dl, torch.as_tensor(
        lo.astype(np.int64)), torch.as_tensor(hi.astype(np.int64)))
    want_h, want_l = js.sobol_bits64_pair(dh, dl, jnp.asarray(lo),
                                          jnp.asarray(hi))
    np.testing.assert_array_equal(_np(got_h), np.asarray(want_h))
    np.testing.assert_array_equal(_np(got_l), np.asarray(want_l))


@pytest.mark.parametrize("offset,first", [(0, 0), (0, 2**32 - 300),
                                          (2**33 + 777, 5),
                                          (2**32 - 100, 2**32 - 50),
                                          (2**62 - 1000, 17)])
def test_split_index64_and_words_match_jax(offset, first):
    n = 400
    got_lo, got_hi = ps._split_index64(offset, first, n)
    want_lo, want_hi = js._split_index64(offset, jnp.uint32(first), n)
    np.testing.assert_array_equal(_np(got_lo), np.asarray(want_lo))
    np.testing.assert_array_equal(_np(got_hi), np.asarray(want_hi))
    pk, jk = _keys(7)
    deep = offset != 0
    v = js.direction_numbers_hi32(6) if deep else js.direction_numbers(6)
    got = ps.sobol_bits_u32(v, first, n, 6, pk, offset)
    want = js.sobol_bits_u32(jnp.asarray(v), jnp.uint32(first), n, 6, jk,
                             offset)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_split_index64_range():
    with pytest.raises(ValueError, match="index_offset"):
        ps._split_index64(1 << 62, 0, 4)
    with pytest.raises(ValueError, match="64"):
        ps.sobol_bits_u32(js.direction_numbers(4), 0, 8, 4, None, 5)
    with pytest.raises(ValueError, match="dimensions"):
        ps.sobol_bits_u32(js.direction_numbers(4), 0, 8, 6)


def test_points_f32_match_jax_with_the_clamp_below_one():
    """Words within 128 of 2^32 round up to 1.0 in the float conversion;
    both packages clamp them to 1 - 2^-24."""
    rng = np.random.default_rng(3)
    v = js.direction_numbers(12)
    pk, jk = _keys(3)
    for first in (0, 4093, 2**31 + 5):
        got = ps.sobol_points_f32(v, first, 2000, 12, pk)
        want = js.sobol_points_f32(jnp.asarray(v), jnp.uint32(first), 2000,
                                   12, jk)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    # a table whose words sit at the top of the range
    top = _u32(rng, (4, 32), top=True)
    got = ps.sobol_points_f32(top, 0, 512, 4)
    want = np.asarray(js.sobol_points_f32(jnp.asarray(top), jnp.uint32(0),
                                          512, 4))
    np.testing.assert_array_equal(_np(got), want)
    assert (want == np.float32(1.0 - 2.0**-24)).any()
    assert _np(got).max() < 1.0


def test_points_f64_match_jax_and_host():
    pk, jk = _keys(11)
    with jax.enable_x64(True):
        for offset in (0, 2**40 + 3):
            for key_p, key_j in ((None, None), (pk, jk)):
                got = ps.sobol_points_f64(5, 9, 300, key_p, offset)
                want = np.asarray(js.sobol_points_f64(
                    5, jnp.uint32(9), 300, key_j, offset))
                assert got.dtype == torch.float64
                np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(ps.sobol_points_f64_host(5, 2**40, 300),
                                  js.sobol_points_f64_host(5, 2**40, 300))
    np.testing.assert_array_equal(_np(ps.sobol_points_f64(5, 0, 300)),
                                  ps.sobol_points_f64_host(5, 0, 300))


def test_normal_icdf_and_erfinv_match_jax():
    rng = np.random.default_rng(4)
    u = np.concatenate([rng.uniform(0, 1, 4000), [0.0, 1e-9, 1e-7, 0.5,
                                                  1 - 1e-8, 1.0]]
                       ).astype(np.float32)
    x = np.concatenate([rng.uniform(-1, 1, 4000), [-0.9999, 0.0, 0.99999]]
                       ).astype(np.float32)
    got_e = _np(port_normal.erfinv_f32(torch.as_tensor(x)))
    want_e = np.asarray(jax_normal.erfinv_f32(jnp.asarray(x)))
    got_z = _np(port_normal.normal_icdf(torch.as_tensor(u)))
    want_z = np.asarray(jax_normal.normal_icdf(jnp.asarray(u)))
    assert np.isfinite(got_z).all()
    # XLA on the CPU contracts the polynomial steps into fmas (ROADMAP
    # queue 3): the last bits may differ
    np.testing.assert_allclose(got_e, want_e, rtol=5e-7, atol=1e-7)
    np.testing.assert_allclose(got_z, want_z, rtol=5e-7, atol=1e-7)
    assert (got_z == want_z).mean() > 0.5
