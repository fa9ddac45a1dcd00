"""Host analytics that fix a run's grids: the log-growth moments, the
final-value histogram's range, the keep factors and the bands' z-grid.

Frozen copy of ``log_growth_moments``, ``make_histogram_spec`` and
``_keep_factors_np`` from ``stock_market_monte_carlo_torch/engine/
engine.py``, ``default_histogram_spec`` and ``HistogramSpec`` from
``ops/reductions.py``, and ``band_grid``, ``hist_coefficients`` and
``cdf_coefficients`` from ``engine/bands.py``, at commit b0a87fd, for the
models and strategies the benchmark's configurations use. Nothing here
imports the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

Z_RANGE = 12.0


def log_growth_moments(model: dict, table) -> tuple:
    """(mean, std) of log((100 + r)/100): 201-node Gauss-Hermite
    quadrature for a Gaussian model (no table), the table's exact moments
    for the bootstrap."""
    if table is None:
        mean = float(model["args"]["mean_pct"])
        std = float(model["args"]["std_pct"])
        z, w = np.polynomial.hermite_e.hermegauss(201)
        g = np.clip(mean + std * z, -99.99, None)
        f = np.log((100.0 + g) / 100.0)
        w = w / w.sum()
        mu = float(np.sum(w * f))
        var = float(np.sum(w * f * f) - mu * mu)
        return mu, float(np.sqrt(max(var, 1e-30)))
    f = np.log((100.0 + np.clip(np.asarray(table, np.float64), -99.99,
                                None)) / 100.0)
    return float(f.mean()), float(np.sqrt(max(float(f.var()), 1e-30)))


def keep_factors(strategy: dict, n_periods: int):
    """(T,) float32 keep fraction a month, or None without a withdrawal."""
    if strategy["kind"] == "none":
        return None
    if strategy["kind"] != "fixed_percent":
        raise ValueError(f"no reference strategy {strategy['kind']!r}")
    pct = np.float32(strategy["args"]["percent"])
    keep = np.float32(1.0) - pct / np.float32(100.0)
    return np.full((n_periods,), keep, np.float32)


@dataclasses.dataclass(frozen=True)
class HistogramSpec:
    """Log-spaced bins on [lo, hi) with an underflow and an overflow
    cell."""

    lo: float
    hi: float
    n_bins: int

    @property
    def log_lo(self):
        return float(np.log(self.lo))

    @property
    def width(self):
        return (float(np.log(self.hi)) - self.log_lo) / self.n_bins


def histogram_spec(model: dict, table, strategy: dict, n_periods: int,
                   v0: float, n_bins: int) -> HistogramSpec:
    """+/-12 sigma of the log final value around its mean; a percent
    withdrawal moves the centre by its log keep and widens the low end."""
    mu, sigma = log_growth_moments(model, table)
    if strategy["kind"] == "fixed_percent":
        pct = np.float64(strategy["args"]["percent"])
        keep = np.clip(1.0 - pct / 100.0, 1e-6, None)
        mu += float(np.mean(np.log(keep)))
    t = float(n_periods)
    center = np.log(v0) + t * mu
    half = 12.0 * np.sqrt(t) * sigma + 1e-6
    lo, hi = float(np.exp(center - half)), float(np.exp(center + half))
    if strategy["kind"] != "none":
        lo = max(min(lo, v0 * 1e-6 + 1e-30), 1e-30)
        hi = max(hi, lo * 1e6)
    return HistogramSpec(lo=lo, hi=hi, n_bins=n_bins)


def band_grid(model: dict, table, strategy: dict, n_periods: int,
              v0: float):
    """(centers, scales), (T+1,) each: month t's log centre log(v0) +
    t*mu and log scale sigma*sqrt(t); a percent withdrawal moves the
    centres by half its log keep a month."""
    mu, sigma = log_growth_moments(model, table)
    months = np.arange(n_periods + 1)
    centers = np.log(v0) + months * mu
    keep = keep_factors(strategy, max(n_periods, 1))
    if keep is not None:
        centers = centers + months * np.log(max(1e-6, float(np.min(keep)))
                                            ) * 0.5
    return centers, np.maximum(sigma * np.sqrt(np.maximum(months, 1)), 1e-9)


def hist_coefficients(centers, scales, n_bins: int, v0: float):
    """float32 (T,) A_t, B_t of months 1..T (cell floor(log V * A_t + B_t)
    + 1) and month 0's cell of v0."""
    nb2z = n_bins / (2.0 * Z_RANGE)
    inv_s = 1.0 / scales
    coef_a = (inv_s[1:] * nb2z).astype(np.float32)
    coef_b = ((Z_RANGE - centers[1:] * inv_s[1:]) * nb2z).astype(np.float32)
    z0 = (np.log(v0) - centers[0]) * inv_s[0]
    idx0 = int(np.clip(int(np.floor((z0 + Z_RANGE) * nb2z)) + 1, 0,
                       n_bins + 1))
    return coef_a, coef_b, idx0


def cdf_coefficients(centers, scales, n_thresholds: int, v0: float):
    """(coef_a, coef_b, kappa_lo, kappa_hi, logthr, m0row): thresholds at
    uniform z in [-6, 6], guard rows at -/+14 z, log thr[t, k] = A_t + kk_k
    * B_t; ``logthr`` the (T+1, K) grid in float32 arithmetic, ``m0row``
    month 0's counts below per path at v0."""
    z_int, z_guard = 6.0, 14.0
    dz = 2.0 * z_int / (n_thresholds - 3)
    z0 = -z_int - dz
    kap_lo = (-z_guard - z0) / dz
    kap_hi = (z_guard - z0) / dz
    kkv = np.arange(n_thresholds, dtype=np.float64)
    kkv[0], kkv[-1] = kap_lo, kap_hi
    cdf_a = (centers + z0 * scales).astype(np.float32)
    cdf_b = (dz * scales).astype(np.float32)
    logthr = (cdf_a[:, None] + kkv.astype(np.float32)[None, :]
              * cdf_b[:, None]).astype(np.float64)
    m0row = (np.log(v0) < logthr[0]).astype(np.float64)
    return cdf_a[1:], cdf_b[1:], kap_lo, kap_hi, logthr, m0row
