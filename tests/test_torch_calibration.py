"""The headline's calibration kernels and the counts-below-tile kernel:
their plain PyTorch versions against the JAX experiments' and test's own
Pallas kernels, on the CPU.

The JAX side loads ``experiments/exp_grid_overhead.py`` and
``experiments/exp_hist_roofline.py`` by path and runs their kernels with
``pl.pallas_call`` in interpret mode; the TPU's hardware PRNG is replaced by
the arithmetic counter stream the port draws (``prng_seed`` stashes the
seed, ``prng_random_bits`` returns ``pallas_engine._arith_bits(seed, 0,
shape)``), and the grid overhead runs 32 tiles. All patches go through
``monkeypatch``; the JAX package is not touched.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_torch.bench import roofline
from stock_market_monte_carlo_torch.ops import bands as port_bands
from stock_market_monte_carlo_torch.ops import calibration as cal
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_tpu.ops import pallas_bands as pb
from stock_market_monte_carlo_tpu.ops import pallas_engine as pe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TILES = 32
GRID_SEED = 12345
CALIB_SEED = 123
# XLA sums a tile's 64 rows in another order than the kernel and its plain
# version, which sum them in row order (not sequential, not a pairwise
# tree, not strided): sums of ~32 differ by up to 1.5e-5, 5e-7 relative
PARTIALS_REL = 1e-6
# XLA's CPU backend contracts 1 + y * 1e-12 into an fma; the port rounds
# the product and the sum (-fmad=false on the card): 0.3-0.7 % of the
# totals lie one ulp (1.2e-7 relative) apart
TOTALS_REL = 1e-6


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "experiments", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def experiments(monkeypatch):
    """(exp_grid_overhead, exp_hist_roofline) with interpret-mode Pallas
    and the counter stream in place of the hardware PRNG."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    state = {}

    def prng_seed(seed):
        state["seed"] = seed

    def prng_random_bits(shape):
        return pe._arith_bits(state["seed"], jnp.int32(0), shape)

    monkeypatch.setattr(pltpu, "prng_seed", prng_seed)
    monkeypatch.setattr(pltpu, "prng_random_bits", prng_random_bits)
    grid = _load("exp_grid_overhead")
    monkeypatch.setattr(grid, "NTILES", N_TILES)
    return grid, _load("exp_hist_roofline")


def _i32(values):
    return np.asarray(values, np.int64).astype(np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# Grid overhead
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["const", "counter"])
@pytest.mark.parametrize("group", [1, 16])
def test_grid_overhead_matches_jax(experiments, variant, group):
    """Finals bit for bit; partials bit for bit (const) or within
    PARTIALS_REL (counter: XLA's row order). Tile offset 5."""
    grid, _ = experiments
    jax_variant = "const" if variant == "const" else "prng"
    iscal = jnp.asarray([GRID_SEED, 5, 0, 0, 0, 0, 0, 0], jnp.int32)
    f_jax, p_jax = (np.asarray(x)
                    for x in jax.jit(grid._make(jax_variant, group))(iscal))
    f, p = cal.grid_overhead_chunk(variant, group, seed=GRID_SEED,
                                   n_tiles=N_TILES, tile0=5, device="cpu")
    assert f.shape == f_jax.shape and p.shape == p_jax.shape
    np.testing.assert_array_equal(f.numpy(), f_jax)
    if variant == "const":
        np.testing.assert_array_equal(p.numpy(), p_jax)
    else:
        assert len(np.unique(f_jax)) > 0.9 * f_jax.size   # full entropy
        np.testing.assert_allclose(p.numpy(), p_jax, rtol=PARTIALS_REL,
                                   atol=0)
        # eight equal partial rows per tile, each the column sum
        tiles = p.numpy().reshape(N_TILES, cal.PARTIAL_ROWS, 128)
        assert (tiles == tiles[:, :1]).all()


def test_grid_overhead_group_changes_nothing():
    one = cal.grid_overhead_chunk_plain("counter", 1, seed=GRID_SEED,
                                        n_tiles=N_TILES)
    sixteen = cal.grid_overhead_chunk_plain("counter", 16, seed=GRID_SEED,
                                            n_tiles=N_TILES)
    assert all(torch.equal(a, b) for a, b in zip(one, sixteen))
    with pytest.raises(ValueError, match="groups"):
        cal.grid_overhead_chunk_plain("const", 3, seed=0, n_tiles=N_TILES)
    with pytest.raises(ValueError, match="variant"):
        cal.grid_overhead_chunk_plain("prng", 1, seed=0, n_tiles=N_TILES)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _jax_calib(monkeypatch, roofline_exp, n_ops, n_periods, n_paths, iscal,
               words):
    """The JAX calibration kernel's totals, or with ``words`` its chain's
    last words: fori_loop is wrapped to hand back the bits of the final
    x in place of the totals."""
    if words:
        real = jax.lax.fori_loop

        def loop(lo, hi, body, init):
            x, _ = real(lo, hi, body, init)
            return x, jax.lax.bitcast_convert_type(x, jnp.float32)

        monkeypatch.setattr(jax.lax, "fori_loop", loop)
    call = roofline_exp.make_calib_call(n_ops, n_periods, n_paths)
    out = np.asarray(jax.jit(call)(jnp.asarray([iscal], jnp.int32)))
    return out.view(np.uint32) if words else out


@pytest.mark.parametrize("n_ops,n_periods,tile0", [
    (16, 16, 0), (16, 12, 0), (48, 12, 0), (48, 16, 3)])
def test_calib_matches_jax(experiments, monkeypatch, n_ops, n_periods,
                           tile0):
    """The integer chain bit for bit; the totals within TOTALS_REL. T=12
    runs 8 months, as the TPU kernel's fori_loop of 8-month steps does; a
    tile offset adds to the seed in both."""
    _, exp = experiments
    n_paths = 2 * ce.TILE_PATHS
    words, totals = cal._calib_plain(n_ops, n_periods=n_periods,
                                     n_paths=n_paths, seed=CALIB_SEED + tile0)
    want = _jax_calib(monkeypatch, exp, n_ops, n_periods, n_paths,
                      CALIB_SEED + tile0, words=False)
    assert totals.shape == want.shape == (n_paths // 128, 128)
    np.testing.assert_allclose(totals.numpy(), want, rtol=TOTALS_REL,
                               atol=0)
    assert (totals.numpy() == want).mean() > 0.9
    want_words = _jax_calib(monkeypatch, exp, n_ops, n_periods, n_paths,
                            CALIB_SEED + tile0, words=True)
    np.testing.assert_array_equal(words.reshape(-1, 128).numpy(),
                                  want_words.astype(np.int64))


def test_calib_months_and_checks():
    assert [cal.calib_months(t) for t in (7, 8, 12, 16, 360)] == [
        0, 8, 8, 16, 360]
    # no whole 8-month step: every total stays 1
    assert bool((cal.calib_chunk_plain(16, n_periods=7, n_paths=8192,
                                       seed=1) == 1.0).all())
    with pytest.raises(ValueError, match="multiple of 4"):
        cal.calib_chunk_plain(18, n_periods=8, n_paths=8192, seed=1)
    with pytest.raises(ValueError, match="multiple of 8192"):
        cal.calib_chunk_plain(16, n_periods=8, n_paths=8000, seed=1)


def test_calib_and_grid_wrappers_run_plain_on_the_cpu():
    ce.reset_launch_counts()
    got = cal.calib_chunk(16, n_periods=8, n_paths=8192, seed=5,
                          device="cpu")
    assert torch.equal(got, cal.calib_chunk_plain(16, n_periods=8,
                                                  n_paths=8192, seed=5))
    f, _ = cal.grid_overhead_chunk("counter", 1, seed=5, n_tiles=2,
                                   device="cpu")
    assert f.shape == (2 * 64, 128)
    assert ce.LAUNCHES["calib"] == ce.LAUNCHES["grid_overhead"] == 0


# ---------------------------------------------------------------------------
# Counts below a tile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_thr,lanes", [(8, "row"), (32, "row"),
                                          (64, "row"), (32, "per_lane")])
def test_counts_below_tile_matches_jax(n_thr, lanes):
    """Against pl.pallas_call of _counts_below_tile in interpret mode, for
    each of its three layouts, bit for bit; thresholds equal across lanes
    (tests/test_bands.py's inputs) or drawn per lane, with a tie row."""
    rng = np.random.default_rng(11)
    tl = np.exp(rng.normal(size=(pe.TILE_ROWS, 128)).astype(np.float32))
    shape = (n_thr, 1) if lanes == "row" else (n_thr, 128)
    thr = np.exp(rng.normal(size=shape).astype(np.float32)) * np.ones(
        (1, 128), np.float32)
    thr[n_thr // 2, :] = tl[3, :]   # ties: strictly below excludes them
    got = port_bands.counts_below_tile(torch.as_tensor(tl),
                                       torch.as_tensor(thr))
    assert got.dtype == torch.int32
    for impl in ("roll", "rows", "bcast3d"):
        def kernel(tl_ref, thr_ref, out_ref, impl=impl):
            out_ref[:] = pb._counts_below_tile(tl_ref[:], thr_ref[:], n_thr,
                                               impl)

        want = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((n_thr, 128), jnp.int32),
            interpret=True)(jnp.asarray(tl), jnp.asarray(thr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{impl} K={n_thr}")


def test_counts_below_tile_checks_shapes():
    tl = torch.ones((64, 128))
    with pytest.raises(ValueError, match="K, 128"):
        port_bands.counts_below_tile(tl, torch.ones((8, 64)))
    with pytest.raises(ValueError, match="64, 128"):
        port_bands.counts_below_tile(torch.ones((32, 128)),
                                     torch.ones((8, 128)))


# ---------------------------------------------------------------------------
# The counter bits, the SASS count and the bounds
# ---------------------------------------------------------------------------

SEEDS = [0, 1, GRID_SEED, (1 << 31) - 1, 1 << 31, (1 << 31) + 5,
         (1 << 32) - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_bits_match_jax(seed):
    tiles = np.asarray([0, 1, 5, 2047, 1 << 31, (1 << 32) - 1], np.int64)
    want = np.asarray(pe._tile_seed_i32(jnp.int32(_i32(seed)),
                                        jnp.asarray(_i32(tiles))))
    got = ce._tile_seed_i32(seed, torch.as_tensor(tiles))
    np.testing.assert_array_equal(_i32(got.numpy()), want)
    for key in (0, 7):
        want = np.asarray(pe._arith_bits(jnp.int32(_i32(seed)),
                                         jnp.int32(key), (64, 128)))
        got = ce._arith_bits(seed, key, torch.arange(ce.TILE_PATHS))
        np.testing.assert_array_equal(_i32(got.numpy()).reshape(64, 128),
                                      want)


# a cuobjdump -sass listing: a loop of four instructions and a NOP, and
# the trap loop of one instruction after EXIT
_SASS = """
        Function : _ZN12_GLOBAL__N_112calib_kernelILi16EEEvjiiPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0 */
                                                            /* 0x0 */
        /*0010*/                   SHF.R.U32.HI R3, RZ, 0x7, R2 ;
        /*0020*/                   LOP3.LUT R2, R3, R2, RZ, 0x3c, !PT ;
        /*0030*/                   IMAD R2, R2, -0x61c8864f, 0x1 ;
        /*0040*/                   NOP ;
        /*0050*/               @P0 BRA 0x10 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
"""


def test_loop_instructions_reads_a_listing():
    assert cal.loop_instructions(_SASS) == 4
    with pytest.raises(ValueError, match="no loop"):
        cal.loop_instructions("        /*0000*/      EXIT ;\n")


def test_new_kernels_bounds(monkeypatch):
    """The grid overhead writes 75.5 MB a 2^24-path chunk (22.5 us at
    3.35 TB/s); the calibration's operations are its SASS instructions;
    the counts below a tile move a few KB."""
    ms, by, w = roofline.bound("grid_overhead", ("const", 16),
                               dict(n_tiles=2048))
    assert w["bytes"] == 75_497_472 and by == "bytes"
    assert ms == pytest.approx(0.022536, rel=1e-4)
    monkeypatch.setattr(cal, "calib_sass_instructions",
                        lambda: {16: 24.5, 48: 64.5})
    ms, by, w = roofline.bound("calib", (48,), dict(n_periods=12,
                                                    n_paths=1 << 24))
    assert by == "operations"
    assert w["scalar_ops"] == (1 << 24) * 8 * 64.5
    _, by, w = roofline.bound("counts_below_tile", (torch.ones(64, 128),
                                                    torch.ones(32, 128)), {})
    assert w["bytes"] == (64 + 2 * 32) * 128 * 4 and by == "bytes"
