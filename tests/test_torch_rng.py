"""The reference-parity stream against the JAX package, on the CPU: the
generators of ``ops/rng.py`` bit for bit, and ``HistoricalBootstrap(
rng="reference")`` through the engine.

The JAX side runs its reference-parity month-loop kernel in interpret mode
(an arithmetic stream, so at full fidelity) with 8192-path chunks; the
port runs the plain PyTorch version of its kernel (device="cpu"). Finals
are bit-exact except under the fixed amount, where XLA on the CPU
contracts total * g - amount into an fma (ROADMAP queue 3).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_torch.ops import rng as port_rng
from stock_market_monte_carlo_torch.ops import threefry
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions
from stock_market_monte_carlo_tpu.engine import engine as jax_engine
from stock_market_monte_carlo_tpu.ops import rng as jax_rng
from test_torch_engine import (
    CPU,
    FINALS_REL,
    STRATEGY_NAMES,
    _assert_same_stats,
    _strategy,
)

N_RAGGED = 2 * 8192 + 5


def _inputs(shape=(3000,), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    x.reshape(-1)[:4] = (0, 1, 2**31, 2**32 - 1)
    return x


def _same(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got, want.astype(np.int64))


# ---------------------------------------------------------------------------
# The generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pcg_hash", "xorshf96",
                                  "uniform_from_bits"])
def test_hashes_match_jax(name):
    x = _inputs()
    _same(getattr(port_rng, name)(torch.as_tensor(x.astype(np.int64))),
          getattr(jax_rng, name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["xorshift_step", "xorshift_gm_step"])
def test_xorshift_steps_match_jax(name):
    state_p, state_j = torch.as_tensor(_inputs().astype(np.int64)), \
        jnp.asarray(_inputs())
    for _ in range(5):
        state_p, out_p = getattr(port_rng, name)(state_p)
        state_j, out_j = getattr(jax_rng, name)(state_j)
        _same(out_p, out_j)
        _same(state_p, state_j)


def test_taus_and_lcg_steps_match_jax():
    x = _inputs()
    xp = torch.as_tensor(x.astype(np.int64))
    for args in ((13, 19, 12, 4294967294), (2, 25, 4, 4294967288),
                 (3, 11, 17, 4294967280)):
        _same(port_rng.taus_step(xp, *args),
              jax_rng.taus_step(jnp.asarray(x), *args))
    _same(port_rng.lcg_step(xp, 1664525, 1013904223),
          jax_rng.lcg_step(jnp.asarray(x), 1664525, 1013904223))


@pytest.mark.parametrize("name,width", [("hybrid_taus_step", 4),
                                        ("hybrid_taus_simple_step", 2),
                                        ("hybrid_taus_simplest_step", None)])
def test_hybrid_taus_match_jax(name, width):
    x = _inputs((500, width) if width else (500,), seed=1)
    state_p, state_j = torch.as_tensor(x.astype(np.int64)), jnp.asarray(x)
    for _ in range(4):
        state_p, u_p = getattr(port_rng, name)(state_p)
        state_j, u_j = getattr(jax_rng, name)(state_j)
        _same(state_p, state_j)
        _same(u_p, u_j)
        assert u_p.dtype == torch.float32


def test_xorshift_stream_and_index_maps_match_jax():
    lanes = (np.arange(2000, dtype=np.uint32) * np.uint32(2654435761))
    bits_p = port_rng.xorshift_stream(
        torch.as_tensor(lanes.astype(np.int64)), 9)
    bits_j = jax_rng.xorshift_stream(jnp.asarray(lanes), 9)
    _same(bits_p, bits_j)
    for n in (1, 97, 1127, 32767):
        _same(port_rng.bootstrap_index_exact(bits_p, n),
              jax_rng.bootstrap_index_exact(bits_j, n))
        _same(port_rng.bootstrap_index_from_bits(bits_p, n),
              jax_rng.bootstrap_index_from_bits(bits_j, n))


# ---------------------------------------------------------------------------
# HistoricalBootstrap(rng="reference") through the engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_model():
    return smmc.HistoricalBootstrap.from_csv(rng="reference")


@functools.lru_cache(maxsize=None)
def _jax_run(name, n, t, seed):
    return smmc.simulate_stats(
        _reference_model(), n, t, seed=seed, strategy=_strategy(name),
        target_amount=1000.0, keep_final_values=True,
        options=JaxOptions(backend="pallas", chunk_paths=8192))


@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_reference_month_loop_matches_jax(name):
    """A ragged 2*8192+5 run: three chunks, the last one short."""
    want = _jax_run(name, N_RAGGED, 12, 5)
    model = from_reference(_reference_model())
    assert model.rng == "reference"
    got = smt.simulate_stats(model, N_RAGGED, 12, seed=5,
                             strategy=from_reference(_strategy(name)),
                             target_amount=1000.0, keep_final_values=True,
                             options=smt.EngineOptions(**CPU))
    finals_rel = FINALS_REL.get(name, 0.0)
    np.testing.assert_allclose(got.final_values, want.final_values,
                               rtol=finals_rel, atol=0)
    _assert_same_stats(got, want, moments_rel=1e-6, std_rel=1e-5,
                       finals_rel=finals_rel)


def test_reference_stream_is_seed_independent():
    """The stream is a function of the path id only, as the JAX
    package's: another seed gives the same finals."""
    model = smt.HistoricalBootstrap.from_csv(rng="reference")
    a = smt.simulate_final_values(model, 8192 + 3, 12, seed=5,
                                  options=smt.EngineOptions(**CPU))
    b = smt.simulate_final_values(model, 8192 + 3, 12, seed=99,
                                  options=smt.EngineOptions(**CPU))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, _jax_run("none", N_RAGGED, 12, 5).final_values[:8192 + 3])


@pytest.mark.parametrize("path_offset", [0, 8000, 2**32 - 300])
def test_reference_trajectories_match_jax(path_offset):
    model = _reference_model()
    strategy = smmc.FixedPercentWithdrawal(0.4)
    want = smmc.simulate_paths(model, 300, 24, 1000.0, 3, strategy,
                               path_offset=path_offset)
    got = smt.simulate_paths(from_reference(model), 300, 24, 1000.0, 3,
                             from_reference(strategy),
                             path_offset=path_offset,
                             options=smt.EngineOptions(device="cpu"))
    # XLA's cumulative product associates in another order (queue 3)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    growth = port_engine.sample_growth(
        from_reference(model), threefry.key(3), None, path_offset, (64, 24))
    want_g = jax_engine.sample_growth(model, None, None,
                                      jnp.uint32(path_offset), (64, 24))
    np.testing.assert_array_equal(growth.numpy(), np.asarray(want_g))


def test_reference_hist_bands_match_jax():
    """hist-mode bands of the reference stream run the trajectory route
    in both packages (no band kernel draws it)."""
    model = _reference_model()
    kw = dict(seed=2, strategy=smmc.FixedPercentWithdrawal(0.2),
              sample_paths=3, n_bins=256)
    want = smmc.simulate_bands(model, 8192 + 77, 12, **kw)
    got = smt.simulate_bands(
        from_reference(model), 8192 + 77, 12, seed=2,
        strategy=from_reference(kw["strategy"]), sample_paths=3, n_bins=256,
        options=smt.EngineOptions(device="cpu"))
    np.testing.assert_array_equal(got.month_hist.sum(1), 8192 + 77)
    # a value within an ulp of a cell edge may move one count (queue 3)
    assert np.abs(got.month_hist - want.month_hist).max() <= 2
    np.testing.assert_allclose(got.values, want.values, rtol=1e-4)
    np.testing.assert_allclose(got.sample_paths, want.sample_paths,
                               rtol=2e-6)


def test_reference_stream_refuses_a_second_segment():
    model = smt.HistoricalBootstrap.from_csv(rng="reference")
    opts = smt.EngineOptions(device="cpu", chunk_paths=8192,
                             seed_segment_paths=8192)
    with pytest.raises(ValueError, match="repeat segment 0"):
        smt.simulate_stats(model, 8192 + 1, 12, options=opts)
    with pytest.raises(ValueError, match="rng must be"):
        smt.HistoricalBootstrap(model.returns_pct, rng="other")
