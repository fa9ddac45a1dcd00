"""The bands' host inversion: per-month counts to fund values at the
quantile levels.

Frozen copy of ``grid_quantiles``, ``norm_icdf64`` and
``cdf_band_quantiles`` from ``stock_market_monte_carlo_torch/ops/
reductions.py`` and of the inversion at the end of ``simulate_bands``
(``engine/bands.py``), at commit b0a87fd. numpy, float64; nothing here
imports the port.
"""

from __future__ import annotations

import numpy as np

from smmc_bench.reference.analytics import Z_RANGE


def grid_quantiles(counts, grid_edges, qs) -> np.ndarray:
    """Histogram quantiles on a monotone grid of cells + 1 edges, linear
    inside a cell in grid space."""
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    cdf = np.cumsum(counts)
    out = []
    for q in np.atleast_1d(qs):
        rank = q * total
        b = min(int(np.searchsorted(cdf, rank, side="left")),
                len(counts) - 1)
        prev = cdf[b - 1] if b > 0 else 0.0
        frac = (rank - prev) / counts[b] if counts[b] > 0 else 0.5
        out.append(grid_edges[b] + frac * (grid_edges[b + 1]
                                           - grid_edges[b]))
    return np.asarray(out)


def norm_icdf64(p):
    """Float64 standard-normal quantile (Acklam's rational
    approximation)."""
    p = np.asarray(p, np.float64)
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p = np.clip(p, 1e-300, 1.0 - 1e-16)
    out = np.empty_like(p)
    lo = p < 0.02425
    hi = p > 1.0 - 0.02425
    mid = ~(lo | hi)

    def tail(pp):
        q = np.sqrt(-2.0 * np.log(pp))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) \
            * q + c[5]
        den = (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
        return num / den

    out[lo] = tail(p[lo])
    out[hi] = -tail(1.0 - p[hi])
    q = p[mid] - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) \
        * r + a[5]
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) \
        * r + 1.0
    out[mid] = q * num / den
    return out


def cdf_band_quantiles(counts_below, log_thresholds, qs,
                       n_valid: int) -> np.ndarray:
    """Log-value quantiles from counts below K ascending thresholds, by
    interpolation in probit space; -inf below the first (guard) threshold,
    the last threshold past the last."""
    F = np.asarray(counts_below, np.float64) / float(n_valid)
    L = np.asarray(log_thresholds, np.float64)
    eps = 0.5 / float(max(n_valid, 1))
    z = norm_icdf64(np.clip(F, eps, 1.0 - eps))
    out = []
    for q in np.atleast_1d(qs):
        j = int(np.searchsorted(F, q, side="left"))
        if j == 0:
            out.append(-np.inf)
            continue
        if j >= len(F):
            out.append(L[-1])
            continue
        za, zb = z[j - 1], z[j]
        if zb <= za:
            w = 0.5
        else:
            zq = float(norm_icdf64(np.clip(q, eps, 1.0 - eps)))
            w = float(np.clip((zq - za) / (zb - za), 0.0, 1.0))
        out.append(L[j - 1] + w * (L[j] - L[j - 1]))
    return np.asarray(out)


def band_values(mode, counts, levels, centers, scales, logthr, n_paths,
                v0) -> np.ndarray:
    """(levels, T+1) fund values of the bands from the (T+1, cells)
    per-month counts: probit interpolation of the counts below thresholds
    ("cdf", month 0 at v0), or the z-grid histogram's quantiles ("hist");
    a rank in the depleted mass reads 0."""
    t1 = counts.shape[0]
    values = np.empty((len(levels), t1))
    if mode == "cdf":
        values[:, 0] = v0
        for tt in range(1, t1):
            lq = cdf_band_quantiles(counts[tt], logthr[tt], levels, n_paths)
            v = np.exp(lq)
            v[~np.isfinite(lq)] = 0.0
            values[:, tt] = v
        return values
    n_bins = counts.shape[1] - 2
    z_edges = np.linspace(-Z_RANGE, Z_RANGE, n_bins + 1)
    pad = z_edges[1] - z_edges[0]
    full = np.concatenate([[z_edges[0] - pad], z_edges, [z_edges[-1] + pad]])
    for tt in range(t1):
        zq = grid_quantiles(counts[tt], full, levels)
        v = np.exp(centers[tt] + zq * scales[tt])
        v[zq < z_edges[0]] = 0.0
        values[:, tt] = v
    return values
