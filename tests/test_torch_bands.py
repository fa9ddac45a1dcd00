"""The port's ``simulate_bands`` in hist mode, its band-histogram kernel's
plain version and the fixed-amount (linear) route, against the JAX package
on the CPU. The cdf and analytic modes, the host inversions and the
rejections are tests/test_torch_bands_cdf.py.

The JAX side runs as tests/test_torch_gaussian.py runs it: the arithmetic
counter stream (SMMC_PRNG_IMPL=arith), the Pallas band kernels in
interpret mode and 8192-path chunks. The port runs its plain versions
(device="cpu"). Both get the same inputs.

Bars: every month's mass is exact. A cell may differ only by values within
a few ulp of a bin edge: XLA contracts ``log V * A + B`` into an fma and
its log differs from torch's by an ulp, and a Gaussian value inherits the
ulp of the normal draw (``near_edges`` counts such values from the
port's own sample; each may move one count to a neighbour). Band values
then agree to BAND_REL.
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
from stock_market_monte_carlo_torch.ops import bands as kb
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions
from test_torch_engine import CPU, _strategy

N, T = 8192 + 100, 4
N_BINS = 256
MODELS = {"historical": smmc.HistoricalBootstrap.from_csv(),
          "gaussian": smmc.GaussianReturns()}
PERCENT_NAMES = ("none", "fixed_percent", "variable_percent")
# a cell count that moves to a neighbour shifts the interpolated quantile
# by a fraction of a bin; measured 8.5e-7 at most
BAND_REL = 1e-4
# the sample paths: trajectories at T=4 (tests/test_torch_threefry.py)
SAMPLE_REL = 2e-6
# a value counts as near an edge (or a threshold) within this much in log
# space: a Gaussian value carries a few ulp after T months (~5e-7
# relative), the log an ulp of ~7 (~5e-7), a threshold's A + kk * B an ulp
# of A (~5e-7)
LOG_TOL = 4e-6


def jax_bands(monkeypatch, kind, name, n=N, t=T, chunk=8192, **kw):
    monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
    return smmc.simulate_bands(
        MODELS[kind], n, t, seed=2, strategy=_strategy(name),
        sample_paths=3, options=JaxOptions(backend="pallas",
                                           chunk_paths=chunk), **kw)


def port_bands_run(kind, name, n=N, t=T, chunk=8192, **kw):
    return smt.simulate_bands(
        from_reference(MODELS[kind]), n, t, seed=2,
        strategy=from_reference(_strategy(name)), sample_paths=3,
        options=smt.EngineOptions(**dict(CPU, chunk_paths=chunk)), **kw)


def port_values(kind, name, n=N, t=T, seed=2, tile0=0):
    """(t, n) float64: the values of paths [tile0 * 8192, + n) of the
    arithmetic stream after months 1..t, from the plain band helper (the
    kernels' sample)."""
    model = from_reference(MODELS[kind])
    strategy = from_reference(_strategy(name))
    table, draw = ce.draw_operands(model, torch.device("cpu"))
    keep = (None if strategy.kind == "none" else torch.as_tensor(
        port_engine._keep_factors_np(strategy, t)))
    n_paths = -(-n // ce.TILE_PATHS) * ce.TILE_PATHS
    base = port_engine._segment_base(seed, 0)
    return torch.stack([
        total.reshape(-1)[:n].double()
        for _, total in kb._month_values(
            torch.device("cpu"), table, keep, n_periods=t, seed_base=base,
            tile0=tile0, n_paths=n_paths, v0=1000.0, **draw)]).numpy()


def _near(x, tol):
    return np.abs(x - np.round(x)) <= tol


def near_edges(kind, name, coef_a, coef_b, **kw):
    """Per month 1..T, the values within LOG_TOL of a bin edge of the
    z-grid cell floor(log V * A_t + B_t), in log space."""
    logv = np.log(np.maximum(port_values(kind, name, **kw), 1e-37))
    a = coef_a.astype(np.float64)[:, None]
    x = logv * a + coef_b.astype(np.float64)[:, None]
    return _near(x, LOG_TOL * a + 1e-6 * np.abs(x)).sum(axis=1)


def assert_cells_close(got, want, near):
    """(T, cells) counts of months 1..T: equal masses; cells equal but for
    the near-edge values, each moving one count."""
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    l1 = np.abs(got - want).sum(axis=1)
    assert (l1 <= 2 * near).all(), (l1, near)


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("name", PERCENT_NAMES)
def test_hist_bands_match_jax(kind, name, monkeypatch):
    want = jax_bands(monkeypatch, kind, name, n_bins=N_BINS)
    got = port_bands_run(kind, name, n_bins=N_BINS)
    assert got.mode == want.mode == "hist"
    assert got.month_hist.shape == want.month_hist.shape == (T + 1,
                                                              N_BINS + 2)
    np.testing.assert_array_equal(got.month_hist.sum(axis=1), N)
    np.testing.assert_array_equal(got.month_hist[0], want.month_hist[0])
    np.testing.assert_array_equal(got.centers, want.centers)
    np.testing.assert_array_equal(got.scales, want.scales)
    coef_a, coef_b, _ = port_bands.hist_coefficients(
        got.centers, got.scales, N_BINS, 1000.0)
    assert_cells_close(got.month_hist[1:], want.month_hist[1:],
                       near_edges(kind, name, coef_a, coef_b))
    np.testing.assert_allclose(got.values, want.values, rtol=BAND_REL)
    np.testing.assert_allclose(got.sample_paths, want.sample_paths,
                               rtol=SAMPLE_REL)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_hist_plain_matches_pallas_kernel(kind, monkeypatch):
    """The band-histogram plain version against ``pallas_chunk_month_hist``
    on one chunk at a nonzero tile offset with a ragged valid count."""
    import jax

    from stock_market_monte_carlo_tpu.ops import pallas_bands as pb

    monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
    name, tile0, valid = "fixed_percent", 3, 5000
    model, strategy = MODELS[kind], _strategy(name)
    pm, ps = from_reference(model), from_reference(strategy)
    centers, scales = port_bands.band_grid(pm, ps, T, 1000.0)
    coef_a, coef_b, _ = port_bands.hist_coefficients(centers, scales,
                                                     N_BINS, 1000.0)
    keep = port_engine._keep_factors_np(ps, T)
    want = np.asarray(pb.pallas_chunk_month_hist(
        model, strategy, jax.random.key(2), 1000.0, tile0 * 8192, valid,
        coef_a, coef_b, n_periods=T, chunk_shape_b=8192, n_bins=N_BINS,
        keep=keep))
    table, draw = ce.draw_operands(pm, torch.device("cpu"))
    got = kb.month_hist_chunk(
        table, torch.as_tensor(keep), torch.as_tensor(coef_a),
        torch.as_tensor(coef_b), n_periods=T,
        seed_base=port_engine._segment_base(2, 0), tile0=tile0,
        valid=valid, n_paths=8192, v0=1000.0, n_bins=N_BINS, **draw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().sum(axis=1), valid)
    assert_cells_close(got.numpy(), want, near_edges(
        kind, name, coef_a, coef_b, n=valid, tile0=tile0))


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_linear_bands_match_jax(kind, monkeypatch):
    """A fixed-amount strategy bins the threefry trajectories linearly on
    [0, hi_t], in both packages outside the band kernels. XLA withdraws
    with an fma: a cell may differ for a value near an edge of the linear
    grid or near 0."""
    want = jax_bands(monkeypatch, kind, "fixed_amount", n_bins=N_BINS)
    got = port_bands_run(kind, "fixed_amount", n_bins=N_BINS)
    np.testing.assert_array_equal(got.month_hist.sum(axis=1), N)
    np.testing.assert_array_equal(got.scales, want.scales)
    traj = smt.simulate_paths(
        from_reference(MODELS[kind]), N, T, seed=2,
        strategy=from_reference(_strategy("fixed_amount")),
        options=smt.EngineOptions(**CPU)).astype(np.float64).T
    z = traj / got.scales[:, None] * N_BINS
    near = (_near(z, 1e-5 * np.abs(z) + 1e-6) | (np.abs(traj) < 1e-3)
            ).sum(axis=1)
    assert_cells_close(got.month_hist, want.month_hist, near)
    np.testing.assert_allclose(got.values, want.values, rtol=BAND_REL)


def test_hist_bands_chunk_invariance_and_progress(monkeypatch):
    """Tile-keyed streams: the counts do not depend on the chunk size; the
    progress callback sees each absorbed chunk as the JAX package's
    does."""
    n = 2 * 8192 + 100
    calls, want_calls = [], []
    a = port_bands_run("historical", "none", n=n, n_bins=N_BINS,
                       progress=lambda d, t: calls.append((d, t)))
    b = port_bands_run("historical", "none", n=n, chunk=2 * 8192,
                       n_bins=N_BINS)
    np.testing.assert_array_equal(a.month_hist, b.month_hist)
    np.testing.assert_allclose(a.values, b.values, rtol=1e-12)
    jax_bands(monkeypatch, "historical", "none", n=n, n_bins=N_BINS,
              progress=lambda d, t: want_calls.append((d, t)))
    assert calls == want_calls == [(8192, n), (2 * 8192, n), (n, n)]
