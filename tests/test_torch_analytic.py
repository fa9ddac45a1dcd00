"""The port's long-run oracles (``ops/analytic.py``: the CLT sampler's law,
its block kurtosis and tail deviation, quantiles and moments of the laws)
and reductions (``ops/reductions.py``: ``packed_stats``,
``merge_packed_stats``, ``welford_combine``, ``exact_quantiles``) against
their JAX twins on the same seeded inputs, on the CPU; then the checks of
tests/test_clt_tail.py and tests/test_reductions.py that need no engine,
on the port.

Bars: the analytic functions are numpy copies, held at 1e-12 relative;
``clt_tail_deviation`` takes z as a float32 normal quantile on each side
and ``packed_stats`` sums in float32 in XLA's order and in torch's, held
at float32 rounding; counts, minima, maxima and ``welford_combine``'s n
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_torch.ops import analytic as an
from stock_market_monte_carlo_torch.ops import reductions as red
from stock_market_monte_carlo_tpu.ops import analytic as jan
from stock_market_monte_carlo_tpu.ops import reductions as jred

MARKET = (0.5, 10 / 12)
PS = [1e-6, 1e-5, 1e-4, 1e-3, 0.05, 0.5, 1 - 1e-3, 1 - 1e-4, 1 - 1e-5]
NUMPY_REL = 1e-12
# float32 sums of ~5000 values in two orders: a few units of 2^-24 times
# the square root of the count
SUM_REL = 1e-5


# ---------------------------------------------------------------------------
# Against the JAX twins
# ---------------------------------------------------------------------------


def test_clt_column_weights_match_jax():
    np.testing.assert_allclose(an.clt_column_weights(),
                               jan.clt_column_weights(), rtol=NUMPY_REL,
                               atol=0)


@pytest.mark.parametrize("col", [0, 17, 127])
def test_clt_z_pdf_matches_jax(col):
    w = an.clt_column_weights()[:, col]
    for got, want in zip(an.clt_z_pdf(w), jan.clt_z_pdf(w)):
        np.testing.assert_allclose(got, want, rtol=NUMPY_REL, atol=0)


@pytest.mark.parametrize("law", ["clt", "normal"])
@pytest.mark.parametrize("n_periods", [7, 12])
def test_clt_final_value_distribution_matches_jax(law, n_periods):
    got = an.clt_final_value_distribution(*MARKET, n_periods, 1000.0,
                                          law=law)
    want = jan.clt_final_value_distribution(*MARKET, n_periods, 1000.0,
                                            law=law)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=NUMPY_REL, atol=0)


@pytest.mark.parametrize("n_periods", [7, 60, 128, 360])
def test_clt_block_kurtosis_matches_jax(n_periods):
    assert an.clt_block_kurtosis(*MARKET, n_periods) == pytest.approx(
        jan.clt_block_kurtosis(*MARKET, n_periods), rel=NUMPY_REL)


@pytest.mark.parametrize("p", PS)
def test_clt_tail_deviation_matches_jax(p):
    """z is each side's float32 normal quantile: the same erfinv
    polynomial, so the two agree to float32 rounding of z (x3 through
    z^3)."""
    got = an.clt_tail_deviation(p, *MARKET, 360)
    want = jan.clt_tail_deviation(p, *MARKET, 360)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_quantiles_from_cdf_matches_jax():
    values, cdf = an.final_value_distribution(*MARKET, 12, 1000.0)
    np.testing.assert_allclose(an.quantiles_from_cdf(values, cdf, PS),
                               jan.quantiles_from_cdf(values, cdf, PS),
                               rtol=NUMPY_REL)


def test_final_value_quantiles_and_moments_match_jax():
    np.testing.assert_allclose(
        an.final_value_quantiles(*MARKET, 360, 1000.0, PS),
        jan.final_value_quantiles(*MARKET, 360, 1000.0, PS),
        rtol=NUMPY_REL)
    np.testing.assert_allclose(
        an.final_value_moments(*MARKET, 360, 1000.0),
        jan.final_value_moments(*MARKET, 360, 1000.0), rtol=NUMPY_REL)


def _samples(seed, n):
    return np.random.default_rng(seed).lognormal(7, 1, n).astype(np.float32)


@pytest.mark.parametrize("withdrawn", [False, True])
def test_packed_stats_matches_jax(withdrawn):
    a = _samples(0, 5000)
    w = _samples(1, 5000) * np.float32(0.01) if withdrawn else None
    target = float(np.median(a))
    got = red.packed_stats(torch.from_numpy(a), target,
                           None if w is None else torch.from_numpy(w))
    want = np.asarray(jred.packed_stats(
        jnp.asarray(a), target, None if w is None else jnp.asarray(w)))
    assert got.dtype == torch.float32 and got.shape == (red.N_STATS,)
    got = got.numpy()
    exact = [0, 5, 6, 7]     # n, min, max, count below
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got, want, rtol=SUM_REL)


def test_merge_packed_stats_matches_jax():
    sa = np.asarray(jred.packed_stats(jnp.asarray(_samples(0, 5000)), 1e3,
                                      None))
    sb = np.asarray(jred.packed_stats(jnp.asarray(_samples(2, 3000)), 1e3,
                                      None))
    got = red.merge_packed_stats(torch.tensor(sa), torch.tensor(sb))
    want = np.asarray(jred.merge_packed_stats(jnp.asarray(sa),
                                              jnp.asarray(sb)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_welford_combine_matches_jax():
    rng = np.random.default_rng(2)
    parts = []
    for n in (1000, 1777):
        x = rng.normal(5, 2, n)
        parts.append((np.float32(n), np.float32(x.mean()),
                      np.float32(((x - x.mean()) ** 2).sum())))
    got = red.welford_combine(*parts)
    want = jred.welford_combine(*parts)
    assert float(got[0]) == float(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert float(g) == pytest.approx(float(w), rel=1e-6)


def test_exact_quantiles_match_jax():
    x = _samples(3, 10_001)
    got = red.exact_quantiles(torch.from_numpy(x), PS)
    want = jred.exact_quantiles(jnp.asarray(x), PS)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_exact_quantiles_sort_route_equals_torch_quantile(monkeypatch):
    """Past the size torch.quantile takes, a sort and the same float32
    interpolation give the same values."""
    x = torch.from_numpy(_samples(4, 4099))
    want = red.exact_quantiles(x, PS + [0.0, 1.0])
    monkeypatch.setattr(red, "_QUANTILE_MAX", 4098)
    np.testing.assert_array_equal(red.exact_quantiles(x, PS + [0.0, 1.0]),
                                  want)


# ---------------------------------------------------------------------------
# tests/test_reductions.py, the engine-free checks, on the port
# ---------------------------------------------------------------------------


def test_packed_stats_and_merge_match_numpy():
    a, b = _samples(0, 5000), _samples(5, 3000)
    target = float(np.median(a))
    merged = red.merge_packed_stats(
        red.packed_stats(torch.from_numpy(a), target, None),
        red.packed_stats(torch.from_numpy(b), target, None))
    both = np.concatenate([a, b])
    m = red.MomentSummary.from_packed(merged.numpy().astype(np.float64),
                                      True)
    assert m.n == 8000
    assert m.mean == pytest.approx(both.mean(), rel=1e-4)
    assert m.std == pytest.approx(both.std(), rel=1e-3)
    assert m.min == pytest.approx(both.min())
    assert m.max == pytest.approx(both.max())
    assert m.count_below == int((both < target).sum())


def test_moment_summary_skew_kurtosis():
    x = np.random.default_rng(1).normal(0, 1, 400_000)
    s = np.zeros(red.N_STATS)
    s[0] = x.size
    s[1:5] = [x.sum(), (x**2).sum(), (x**3).sum(), (x**4).sum()]
    s[5], s[6] = x.min(), x.max()
    m = red.MomentSummary.from_packed(s, False)
    assert abs(m.skew) < 0.02
    assert m.kurtosis == pytest.approx(3.0, abs=0.05)


def test_welford_combine():
    rng = np.random.default_rng(2)
    a = rng.normal(5, 2, 1000)
    b = rng.normal(5, 2, 1777)
    sa = (np.float32(a.size), np.float32(a.mean()),
          np.float32(((a - a.mean()) ** 2).sum()))
    sb = (np.float32(b.size), np.float32(b.mean()),
          np.float32(((b - b.mean()) ** 2).sum()))
    n, mean, m2 = red.welford_combine(sa, sb)
    both = np.concatenate([a, b])
    assert float(n) == both.size
    assert float(mean) == pytest.approx(both.mean(), rel=1e-6)
    assert float(m2) / both.size == pytest.approx(both.var(), rel=1e-5)


# ---------------------------------------------------------------------------
# tests/test_clt_tail.py on the port
# ---------------------------------------------------------------------------


def test_clt_z_pdf_exact_moments():
    """The CF inversion gives z = sum w_i U_i mass 1, mean 0, variance 1
    and excess kurtosis -(1/120) sum w^4."""
    w = an.clt_column_weights()
    assert w.shape == (128, 128)
    np.testing.assert_allclose((w**2).sum(axis=0) / 12.0
                               * (1.0 - 2.0**-32), 1.0, rtol=1e-12)
    for j in (0, 17, 127):
        x, pdf = an.clt_z_pdf(w[:, j])
        dx = x[1] - x[0]
        mass = (pdf * dx).sum()
        mean = (x * pdf * dx).sum()
        var = (x**2 * pdf * dx).sum() - mean**2
        k4 = ((x - mean) ** 4 * pdf * dx).sum() / var**2 - 3.0
        assert abs(mass - 1.0) < 1e-9
        assert abs(mean) < 1e-10
        assert abs(var - 1.0) < 1e-8
        assert abs(k4 + (1.0 / 120.0) * (w[:, j] ** 4).sum()) < 1e-6, j


def test_clt_final_value_tails_match_normal_law():
    """360 months: the CLT sampler's marginal law against the exact normal
    through the same pipeline, within 1e-4 down to p = 1e-5 and 2e-4 at
    1e-6."""
    vc, cc = an.clt_final_value_distribution(*MARKET, 360, 1000.0)
    vn, cn = an.clt_final_value_distribution(*MARKET, 360, 1000.0,
                                             law="normal")
    ps = [1e-6, 1e-5, 1e-4, 0.5, 1 - 1e-4, 1 - 1e-5, 1 - 1e-6]
    qc = an.quantiles_from_cdf(vc, cc, ps)
    qn = an.quantiles_from_cdf(vn, cn, ps)
    dev = np.abs(qc / qn - 1.0)
    assert dev[3] < 2e-5
    assert np.all(dev[[1, 2, 4, 5]] < 1e-4)
    assert np.all(dev[[0, 6]] < 2e-4)
    x5 = qn[1]
    assert abs(float(np.interp(x5, vc, cc)) / float(np.interp(x5, vn, cn))
               - 1.0) < 0.01


def test_clt_block_kurtosis_and_tail_deviation():
    """gamma2 ~ -0.0093 for the default market at 360 months; the
    Cornish-Fisher shifts it predicts match the JAX package's 1e9-path
    TPU measurements (RESULTS.md) in sign and within 0.7-1.5x."""
    g2 = an.clt_block_kurtosis(*MARKET, 360)
    assert -0.012 < g2 < -0.007
    measured = {1e-5: 3.82e-3, 1e-4: 2.28e-3, 1e-3: 1.20e-3,
                1 - 1e-3: -0.93e-3, 1 - 1e-4: -1.92e-3,
                1 - 1e-5: -3.54e-3}
    for p, got in measured.items():
        pred = an.clt_tail_deviation(p, *MARKET, 360)
        assert np.sign(pred) == np.sign(got), p
        assert 0.7 < pred / got < 1.5, (p, pred, got)
    assert abs(an.clt_tail_deviation(0.05, *MARKET, 360)) < 1e-4
    assert abs(an.clt_tail_deviation(0.5, *MARKET, 360)) < 1e-9
    g2_short = an.clt_block_kurtosis(*MARKET, 60)
    assert np.isfinite(g2_short) and g2_short < 0


def test_normal_law_pipeline_matches_independent_oracle():
    """The normal arm of the CLT pipeline (centred wraparound grid) against
    the full-support oracle, which shares no convolution code with it."""
    vn, cn = an.clt_final_value_distribution(*MARKET, 360, 1000.0,
                                             law="normal")
    ps = [1e-4, 0.5, 1 - 1e-4]
    np.testing.assert_allclose(
        an.quantiles_from_cdf(vn, cn, ps),
        an.final_value_quantiles(*MARKET, 360, 1000.0, ps), rtol=1e-4)
