"""The Sobol models through the port's engine against the JAX package, on
the CPU: ``SobolGaussianReturns`` here (the Sobol historical model is
``test_torch_quasi_historical.py``), RQMC, and the limits both packages put
on quasi-random and reference-parity runs.

The JAX side runs its Sobol month-loop kernel in interpret mode (the Sobol
fold is integer arithmetic, so at full fidelity) with 8192-path chunks;
the port runs the plain PyTorch version of its kernel (device="cpu").
The Sobol Gaussian draw rounds as the counter Gaussian draw does: XLA on
the CPU contracts a + b*z and the erfinv steps into fmas (ROADMAP queue
3), so finals meet a relative bar (1e-6 at 12 months) and a count or a
histogram cell may move only for a final within that bar of its edge.
Each JAX result is computed once per module (``_jax_run``): a new
interpret-mode configuration compiles for several seconds.
"""

import functools
import warnings

import numpy as np
import pytest

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions
from stock_market_monte_carlo_tpu.engine import engine as jax_engine
from test_torch_engine import CPU, STRATEGY_NAMES, _assert_hist_close
from test_torch_engine import _strategy

T = 12
N = 2 * 8192 + 5          # three chunks, the last one ragged
TARGET = 1000.0
DEEP = (1 << 33) + 777
GAUSS_REL = 1e-6
# Under the fixed amount the moments are not centred (no analytic mean),
# so the variance cancels mean^2/var ~ 1150 times the float32 rounding of
# the per-path terms: each package's std sits 2-4e-5 from the float64 std
# of its own finals (measured, Sobol Gaussian at T=12), while those agree
# to 2e-8. The bar holds the two stds to that conditioning and the finals'
# own float64 stds to 1e-6.
STD_REL = {"fixed_amount": 1e-4}


@functools.lru_cache(maxsize=None)
def sobol_model(kind, index_offset=0, n_periods=T):
    if kind == "sobol_gaussian":
        return smmc.SobolGaussianReturns.create(n_periods,
                                                index_offset=index_offset)
    return smmc.SobolHistoricalBootstrap.create(
        smmc.HistoricalBootstrap.from_csv().returns_pct, n_periods,
        index_offset=index_offset)


@functools.lru_cache(maxsize=None)
def _jax_run(kind, name, index_offset=0, n=N, seed=5):
    return smmc.simulate_stats(
        sobol_model(kind, index_offset), n, T, seed=seed,
        strategy=_strategy(name), target_amount=TARGET,
        keep_final_values=True,
        options=JaxOptions(backend="pallas", chunk_paths=8192))


def port_run(kind, name, index_offset=0, n=N, seed=5, **kw):
    return smt.simulate_stats(
        from_reference(sobol_model(kind, index_offset)), n, T, seed=seed,
        strategy=from_reference(_strategy(name)), target_amount=TARGET,
        options=smt.EngineOptions(**CPU), **kw)


def assert_matches_jax(kind, name, index_offset=0, finals_rel=0.0):
    """Finals within ``finals_rel`` (0: bit for bit); the count below the
    target and each histogram cell move only for finals within the bar of
    the target or of a cell edge."""
    want = _jax_run(kind, name, index_offset)
    got = port_run(kind, name, index_offset, keep_final_values=True)
    np.testing.assert_allclose(got.final_values, want.final_values,
                               rtol=finals_rel, atol=0)
    gm, wm = got.moments, want.moments
    assert gm.n == wm.n == N
    near = int(np.sum(np.abs(want.final_values / TARGET - 1.0)
                      <= finals_rel))
    assert abs(gm.count_below - wm.count_below) <= near
    assert gm.min == pytest.approx(wm.min, rel=finals_rel, abs=0)
    assert gm.max == pytest.approx(wm.max, rel=finals_rel, abs=0)
    assert gm.mean == pytest.approx(wm.mean, rel=1e-6)
    assert gm.std == pytest.approx(wm.std, rel=STD_REL.get(name, 1e-5))
    assert np.std(got.final_values, dtype=np.float64) == pytest.approx(
        np.std(want.final_values, dtype=np.float64), rel=1e-6)
    assert gm.total_withdrawn == pytest.approx(wm.total_withdrawn, rel=1e-6)
    _assert_hist_close(got.histogram_counts, want.histogram_counts)
    return got


@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_sobol_gaussian_month_loop_matches_jax(name):
    assert_matches_jax("sobol_gaussian", name, finals_rel=GAUSS_REL)


def test_sobol_gaussian_deep_index_matches_jax():
    """index_offset past 2^33: 64-bit positions, the (T, 64) table."""
    model = from_reference(sobol_model("sobol_gaussian", DEEP))
    assert model.direction.shape == (T, 64) and model.index_offset == DEEP
    assert_matches_jax("sobol_gaussian", "none", DEEP, finals_rel=GAUSS_REL)


def test_chunking_keeps_sequence_positions():
    """A run's positions come from its chunks' path offsets: one chunk of
    2^15 (the bucketed single chunk) and four 8192-path chunks give the
    same finals."""
    model = from_reference(sobol_model("sobol_gaussian"))
    one = smt.simulate_final_values(model, N, T, seed=5, options=smt
                                    .EngineOptions(device="cpu"))
    np.testing.assert_array_equal(
        one, port_run("sobol_gaussian", "none", keep_final_values=True)
        .final_values)


def test_sobol_gaussian_trajectories_match_jax():
    model = sobol_model("sobol_gaussian")
    strategy = smmc.FixedPercentWithdrawal(0.4)
    want = smmc.simulate_paths(model, 300, T, 1000.0, 3, strategy,
                               path_offset=8000)
    got = smt.simulate_paths(from_reference(model), 300, T, 1000.0, 3,
                             from_reference(strategy), path_offset=8000,
                             options=smt.EngineOptions(device="cpu"))
    # the normal's ulp (fma contraction in XLA) and cumprod's order
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def test_sobol_gaussian_hist_bands_match_jax():
    model = sobol_model("sobol_gaussian")
    strategy = smmc.FixedPercentWithdrawal(0.2)
    want = smmc.simulate_bands(model, 8192 + 77, T, seed=2,
                               strategy=strategy, sample_paths=3,
                               n_bins=256)
    got = smt.simulate_bands(from_reference(model), 8192 + 77, T, seed=2,
                             strategy=from_reference(strategy),
                             sample_paths=3, n_bins=256,
                             options=smt.EngineOptions(device="cpu"))
    np.testing.assert_array_equal(got.month_hist.sum(1), 8192 + 77)
    assert np.abs(got.month_hist - want.month_hist).max() <= 2
    np.testing.assert_allclose(got.values, want.values, rtol=1e-4)
    np.testing.assert_allclose(got.sample_paths, want.sample_paths,
                               rtol=2e-6)


def test_rqmc_matches_jax():
    model = sobol_model("sobol_gaussian")
    want = smmc.rqmc_estimate(model, 8192, T, replicates=3, seed=4,
                              options=JaxOptions(backend="pallas",
                                                 chunk_paths=8192))
    got = smt.rqmc_estimate(from_reference(model), 8192, T, replicates=3,
                            seed=4, options=smt.EngineOptions(**CPU))
    assert isinstance(got, smt.RqmcEstimate)
    np.testing.assert_allclose(got.replicate_means, want.replicate_means,
                               rtol=1e-6)
    assert got.sem == pytest.approx(want.sem, rel=1e-3)
    assert got.ci_lo < got.mean < got.ci_hi
    assert got.n_paths_per_replicate == 8192
    with pytest.raises(ValueError, match="replicates"):
        smt.rqmc_estimate(from_reference(model), 8192, T, replicates=1)
    with pytest.raises(ValueError, match="target_amount"):
        smt.rqmc_estimate(from_reference(model), 8192, T,
                          statistic="prob_below")
    with pytest.raises(ValueError, match="confidence"):
        smt.rqmc_estimate(from_reference(model), 8192, T, confidence=0.5,
                          options=smt.EngineOptions(**CPU))


def test_t_table_matches_jax():
    from stock_market_monte_carlo_torch.engine import rqmc as port_rqmc
    from stock_market_monte_carlo_tpu.engine import rqmc as jax_rqmc

    for conf in (0.90, 0.95, 0.99):
        for df in (1, 2, 7, 30, 31, 500):
            assert port_rqmc._t_critical(df, conf) == \
                jax_rqmc._t_critical(df, conf)


# ---------------------------------------------------------------------------
# Host analytics, routing and limits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sobol_gaussian", "sobol_historical"])
def test_host_analytics_and_routing_match_jax(kind):
    model = sobol_model(kind)
    pm = from_reference(model)
    for name in STRATEGY_NAMES:
        strategy = _strategy(name)
        ps = from_reference(strategy)
        want = jax_engine.make_histogram_spec(model, strategy, T, 1000.0,
                                              4094)
        got = port_engine.make_histogram_spec(pm, ps, T, 1000.0, 4094)
        assert (got.lo, got.hi, got.n_bins) == (want.lo, want.hi,
                                                want.n_bins)
        assert port_engine.analytic_moment_shift(pm, ps, T) == \
            jax_engine.analytic_moment_shift(model, strategy, T)
        for sampler in ("icdf", "clt", "clt-prefix"):
            opts = smt.EngineOptions(gaussian_sampler=sampler, device="cpu")
            assert port_engine._effective_sampler(pm, ps, opts) == "icdf" \
                == jax_engine._effective_sampler(
                    model, strategy, "pallas",
                    JaxOptions(gaussian_sampler=sampler))
    assert port_engine.log_growth_moments(pm) == \
        jax_engine.log_growth_moments(model)


def _limit_calls():
    cpu = smt.EngineOptions(device="cpu")
    sg = from_reference(sobol_model("sobol_gaussian"))
    deep = from_reference(sobol_model("sobol_gaussian", DEEP))
    ref = smt.HistoricalBootstrap.from_csv(rng="reference")
    return {
        "dims": (lambda: smt.simulate_stats(sg, 8192, T + 1, options=cpu),
                 "Sobol dimensions"),
        "paths_2_31": (lambda: port_engine._validate_run(
            sg, (1 << 31) + 1, 8192, T, seg_paths=1 << 31), "2\\^31"),
        "offset_2_62": (lambda: port_engine._validate_run(
            smt.SobolGaussianReturns(deep.direction,
                                     index_offset=(1 << 62) - 100),
            8192, 8192, T), "2\\^62"),
        "reference_segments": (lambda: smt.simulate_stats(
            ref, 8192 + 1, T, options=smt.EngineOptions(
                device="cpu", chunk_paths=8192, seed_segment_paths=8192)),
            "segment"),
        "terminal_law_sobol": (lambda: smt.simulate_stats(
            sg, 8192, T, options=smt.EngineOptions(device="cpu",
                                                   terminal_law=True)),
            "terminal_law=True needs"),
        "terminal_law_reference": (lambda: smt.simulate_stats(
            ref, 8192, T, options=smt.EngineOptions(device="cpu",
                                                    terminal_law=True)),
            "terminal_law=True needs"),
        "bands_cdf": (lambda: smt.simulate_bands(
            sg, 8192, T, band_mode="cdf", options=cpu), "band_mode='cdf'"),
        "bands_analytic": (lambda: smt.simulate_bands(
            sg, 8192, T, band_mode="analytic", options=cpu),
            "gaussian/historical"),
    }


@pytest.mark.parametrize("case", sorted(_limit_calls()))
def test_limits_raise_as_in_jax(case):
    call, match = _limit_calls()[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_sobol_runs_never_segment():
    """A Sobol run past seed_segment_paths stays one stream: the same
    finals as without segments (the JAX package splits Sobol runs by
    index_offset instead)."""
    model = from_reference(sobol_model("sobol_historical"))
    seg = smt.simulate_final_values(model, N, T, seed=5, options=smt
                                    .EngineOptions(seed_segment_paths=8192,
                                                   **CPU))
    np.testing.assert_array_equal(
        seg, port_run("sobol_historical", "none", keep_final_values=True)
        .final_values)


def test_sobol_gaussian_volatility_warning_as_jax():
    model = smt.SobolGaussianReturns.create(T, mean_pct=0.5, std_pct=20.0)
    with pytest.warns(UserWarning, match="beyond -100%"):
        port_engine._validate_run(model, 8192, 8192, T)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_engine._validate_run(
            from_reference(sobol_model("sobol_gaussian")), 8192, 8192, T)
