"""The port's ``simulate_bands`` in cdf and analytic modes, its
counts-below kernel's plain version, the host inversions and the
rejections, against the JAX package on the CPU (the JAX side as in
tests/test_torch_bands.py).

Bars: a count below a threshold may differ only for a value within
LOG_TOL of that threshold in log space (XLA contracts ``A + kk * B`` into an fma, its
exp may differ by an ulp, and a Gaussian value carries the ulp of its
normal draws); the host functions are numpy on both sides and equal.
"""

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import bands as port_bands
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_torch.ops import analytic as port_analytic
from stock_market_monte_carlo_torch.ops import bands as kb
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_torch.ops import reductions as port_red
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions
from stock_market_monte_carlo_tpu.ops import analytic as jax_analytic
from stock_market_monte_carlo_tpu.ops import pallas_bands as pb
from stock_market_monte_carlo_tpu.ops import reductions as jax_red
from test_torch_bands import (
    BAND_REL,
    LOG_TOL,
    MODELS,
    PERCENT_NAMES,
    SAMPLE_REL,
    T,
    jax_bands,
    port_bands_run,
    port_values,
)
from test_torch_engine import CPU, _strategy

K = 16


def near_thresholds(kind, name, thr, **kw):
    """(T, K): the values within LOG_TOL of each threshold of months
    1..T, in log space."""
    logv = np.log(port_values(kind, name, **kw))
    return (np.abs(logv[:, :, None] - np.log(thr)[:, None, :]) <= LOG_TOL
            ).sum(axis=1)


def assert_counts_close(got, want, near):
    diff = np.abs(got - want)
    assert (diff <= near).all(), (diff.max(), near.max())


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("name", PERCENT_NAMES)
def test_cdf_bands_match_jax(kind, name, monkeypatch):
    want = jax_bands(monkeypatch, kind, name, band_mode="cdf",
                     n_thresholds=K)
    got = port_bands_run(kind, name, band_mode="cdf", n_thresholds=K)
    assert got.mode == want.mode == "cdf"
    assert got.month_hist.shape == want.month_hist.shape == (T + 1, K)
    np.testing.assert_array_equal(got.log_thresholds, want.log_thresholds)
    np.testing.assert_array_equal(got.month_hist[0], want.month_hist[0])
    assert (np.diff(got.month_hist, axis=1) >= 0).all()
    assert_counts_close(got.month_hist[1:], want.month_hist[1:],
                        near_thresholds(kind, name,
                                        np.exp(got.log_thresholds[1:])))
    np.testing.assert_allclose(got.values, want.values, rtol=BAND_REL)
    np.testing.assert_allclose(got.sample_paths, want.sample_paths,
                               rtol=SAMPLE_REL)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_cdf_plain_matches_pallas_kernel(kind, monkeypatch):
    """The counts-below plain version against ``pallas_chunk_month_cdf``
    on one chunk at a nonzero tile offset with a ragged valid count."""
    import jax

    monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
    name, tile0, valid = "variable_percent", 5, 3000
    model, strategy = MODELS[kind], _strategy(name)
    pm, ps = from_reference(model), from_reference(strategy)
    centers, scales = port_bands.band_grid(pm, ps, T, 1000.0)
    coef_a, coef_b, klo, khi, logthr, _ = port_bands.cdf_coefficients(
        centers, scales, K, 1000.0)
    keep = port_engine._keep_factors_np(ps, T)
    want = np.asarray(pb.pallas_chunk_month_cdf(
        model, strategy, jax.random.key(2), 1000.0, tile0 * 8192, valid,
        coef_a, coef_b, klo, khi, n_periods=T, chunk_shape_b=8192,
        n_thresholds=K, keep=keep))
    table, draw = ce.draw_operands(pm, torch.device("cpu"))
    coef_a_t, coef_b_t = torch.as_tensor(coef_a), torch.as_tensor(coef_b)
    got = kb.month_cdf_chunk(
        table, torch.as_tensor(keep), coef_a_t, coef_b_t, n_periods=T,
        seed_base=port_engine._segment_base(2, 0), tile0=tile0,
        valid=valid, n_paths=8192, v0=1000.0, kappa_lo=klo, kappa_hi=khi,
        n_thresholds=K, **draw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    thr = kb.cdf_thresholds(coef_a_t, coef_b_t, klo, khi, K).numpy()
    np.testing.assert_allclose(np.log(thr), logthr[1:], rtol=1e-6)
    assert_counts_close(got.numpy(), want, near_thresholds(
        kind, name, thr, n=valid, tile0=tile0))


def test_cdf_bands_chunk_invariance():
    a = port_bands_run("gaussian", "none", n=2 * 8192 + 100,
                       band_mode="cdf", n_thresholds=K)
    b = port_bands_run("gaussian", "none", n=2 * 8192 + 100,
                       chunk=2 * 8192, band_mode="cdf", n_thresholds=K)
    np.testing.assert_array_equal(a.month_hist, b.month_hist)
    np.testing.assert_allclose(a.values, b.values, rtol=1e-12)


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("name", ["none", "fixed_percent"])
def test_analytic_bands_match_jax(kind, name, monkeypatch):
    want = jax_bands(monkeypatch, kind, name, t=24, band_mode="analytic")
    got = port_bands_run(kind, name, t=24, band_mode="analytic")
    assert got.mode == "analytic" and got.n_paths == want.n_paths == 0
    assert got.month_hist.shape == (25, 0)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-12)
    np.testing.assert_array_equal(got.centers, want.centers)
    np.testing.assert_allclose(got.sample_paths, want.sample_paths,
                               rtol=SAMPLE_REL * 6)


# ---------------------------------------------------------------------------
# Rejections, label for label
# ---------------------------------------------------------------------------

_HIST = MODELS["historical"]
_PALLAS = dict(backend="pallas")
# label: (strategy, simulate_bands keywords, EngineOptions keywords)
_REJECTIONS = {
    "band_mode": (smmc.NoWithdrawal(), dict(band_mode="nope"), {}),
    "terminal_law": (smmc.NoWithdrawal(), {}, dict(terminal_law=True)),
    "analytic_linear": (smmc.FixedAmountWithdrawal(1.0),
                        dict(band_mode="analytic"), {}),
    "cdf_linear": (smmc.FixedAmountWithdrawal(1.0), dict(band_mode="cdf"),
                   _PALLAS),
    "cdf_multiple_of_8": (smmc.NoWithdrawal(),
                          dict(band_mode="cdf", n_thresholds=20), _PALLAS),
    "cdf_accumulator_cap": (smmc.NoWithdrawal(),
                            dict(band_mode="cdf", n_thresholds=8192),
                            _PALLAS),
    "n_paths": (smmc.NoWithdrawal(), dict(n_paths=0), {}),
}


@pytest.mark.parametrize("label", sorted(_REJECTIONS))
def test_band_rejections_match_jax(label):
    strategy, kw, opts = _REJECTIONS[label]
    kw = dict(dict(n_paths=8192), **kw)
    n = kw.pop("n_paths")
    with pytest.raises(ValueError) as want:
        smmc.simulate_bands(_HIST, n, 4, strategy=strategy,
                            options=JaxOptions(**opts), **kw)
    with pytest.raises(ValueError) as got:
        smt.simulate_bands(from_reference(_HIST), n, 4,
                           strategy=from_reference(strategy),
                           options=smt.EngineOptions(**dict(CPU, **opts)),
                           **kw)
    assert str(got.value) == str(want.value)


def test_band_mesh_names_its_roadmap_item():
    """Band meshes are ported (ROADMAP queue 1 item 13, tests/
    test_torch_mesh.py); a mesh that is no ``PathsMesh`` raises."""
    with pytest.raises(TypeError, match="parallel.paths_mesh"):
        smt.simulate_bands(from_reference(_HIST), 8192, 4, mesh=object(),
                           options=smt.EngineOptions(**CPU))


def test_bands_supported_match_jax():
    models = [_HIST, MODELS["gaussian"],
              smmc.HistoricalBootstrap.from_csv(rng="reference"),
              smmc.SobolGaussianReturns.create(8)]
    for model in models:
        for kind in ("none", "fixed_percent", "variable_percent",
                     "fixed_amount"):
            assert kb.bands_supported(model, kind) == pb.bands_supported(
                model, kind)
            for t, k in ((4, 16), (360, 32), (360, 44), (360, 48),
                         (600, 32), (12, 4), (2048, 8), (2049, 8)):
                assert kb.cdf_supported(model, kind, t, k) == \
                    pb.cdf_supported(model, kind, t, k), (t, k)
    assert kb.CDF_THRESHOLDS == pb.CDF_THRESHOLDS


# ---------------------------------------------------------------------------
# Host inversions and laws
# ---------------------------------------------------------------------------


def test_cdf_band_quantiles_match_jax():
    rng = np.random.default_rng(5)
    qs = (0.0001, 0.05, 0.25, 0.5, 0.75, 0.95, 0.9999)
    for n in (1000, 8292, 10**8):
        for _ in range(20):
            counts = np.sort(rng.integers(0, n + 1, K)).astype(np.float64)
            logthr = np.sort(rng.normal(7.0, 1.0, K))
            np.testing.assert_array_equal(
                port_red.cdf_band_quantiles(counts, logthr, qs, n),
                jax_red.cdf_band_quantiles(counts, logthr, qs, n))
    # the depleted mass and the clamp past the last threshold
    counts = np.array([100, 100, 100, 500, 1000, 1000], np.float64)
    logthr = np.linspace(0.0, 5.0, 6)
    got = port_red.cdf_band_quantiles(counts, logthr, (0.05, 0.5, 0.9999),
                                      1000)
    assert got[0] == -np.inf and got[2] == logthr[4]
    np.testing.assert_array_equal(
        got, jax_red.cdf_band_quantiles(counts, logthr, (0.05, 0.5, 0.9999),
                                        1000))


@pytest.mark.parametrize("kind", ["gaussian", "bootstrap"])
@pytest.mark.parametrize("with_keep", [False, True])
def test_marginal_value_quantiles_match_jax(kind, with_keep):
    params = ((0.5, 10.0 / 12) if kind == "gaussian"
              else np.asarray(_HIST.returns_pct, np.float64))
    keep = (np.random.default_rng(3).uniform(0.99, 1.0, 120)
            if with_keep else None)
    qs = (0.05, 0.5, 0.95)
    np.testing.assert_array_equal(
        port_analytic.marginal_value_quantiles(kind, params, 120, 1000.0,
                                               qs, keep=keep),
        jax_analytic.marginal_value_quantiles(kind, params, 120, 1000.0,
                                              qs, keep=keep))
