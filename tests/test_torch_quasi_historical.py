"""``SobolHistoricalBootstrap`` through the port's engine against the JAX
package, on the CPU (as ``test_torch_quasi.py`` runs the Sobol Gaussian
model). The draw is integer up to the table row, so finals are bit for bit
but under the fixed amount, where XLA on the CPU contracts total * g -
amount into an fma (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_torch.ops import threefry
from stock_market_monte_carlo_tpu.engine import engine as jax_engine
from test_torch_engine import FINALS_REL, STRATEGY_NAMES
from test_torch_quasi import DEEP, T, assert_matches_jax, sobol_model


@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_sobol_historical_month_loop_matches_jax(name):
    assert_matches_jax("sobol_historical", name,
                       finals_rel=FINALS_REL.get(name, 0.0))


def test_sobol_historical_deep_index_matches_jax():
    assert_matches_jax("sobol_historical", "none", DEEP)


@pytest.mark.parametrize("index_offset", [0, DEEP])
@pytest.mark.parametrize("path_offset", [0, 8000, 2**31 + 3])
def test_sobol_historical_growth_matches_jax(index_offset, path_offset):
    """sample_growth, the trajectories' draw: the Sobol words at the
    window's positions, scrambled by the seed's key, bit for bit."""
    model = sobol_model("sobol_historical", index_offset)
    want = jax_engine.sample_growth(
        model, None, jax.random.fold_in(jax.random.key(3), 0x50B0),
        jnp.uint32(path_offset), (300, T))
    got = port_engine.sample_growth(
        from_reference(model), threefry.key(3),
        threefry.fold_in(threefry.key(3), 0x50B0), path_offset, (300, T))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sobol_historical_trajectories_match_jax():
    model = sobol_model("sobol_historical")
    strategy = smmc.FixedPercentWithdrawal(0.4)
    want = smmc.simulate_paths(model, 300, T, 1000.0, 3, strategy,
                               path_offset=8000)
    got = smt.simulate_paths(from_reference(model), 300, T, 1000.0, 3,
                             from_reference(strategy), path_offset=8000,
                             options=smt.EngineOptions(device="cpu"))
    # XLA's cumulative product associates in another order (queue 3)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def test_sobol_historical_hist_bands_match_jax():
    model = sobol_model("sobol_historical")
    want = smmc.simulate_bands(model, 8192 + 77, T, seed=2, sample_paths=3,
                               n_bins=256)
    got = smt.simulate_bands(from_reference(model), 8192 + 77, T, seed=2,
                             sample_paths=3, n_bins=256,
                             options=smt.EngineOptions(device="cpu"))
    np.testing.assert_array_equal(got.month_hist.sum(1), 8192 + 77)
    assert np.abs(got.month_hist - want.month_hist).max() <= 2
    np.testing.assert_allclose(got.values, want.values, rtol=1e-4)
    np.testing.assert_allclose(got.sample_paths, want.sample_paths,
                               rtol=2e-6)
