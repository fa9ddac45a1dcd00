"""Exact value laws by FFT convolution (numpy, float64): the oracles the
terminal-law fit samples from, and the per-month marginals of the
analytic bands.

The part of ``stock_market_monte_carlo_tpu.ops.analytic`` that
``terminal_law.fit_terminal_law`` and ``simulate_bands(band_mode=
"analytic")`` need, with the same arithmetic so the fitted operand and the
bands are bit-identical. log V_T is a T-fold convolution of the
single-month log-growth law; it runs as irfft(rfft(p)^T) on a grid padded
so the full T-month support fits without wraparound.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np


def log_growth_pdf_grid(mean_pct: float, std_pct: float,
                        n_grid: int = 1 << 14,
                        z_span: float = 14.0):
    """(y, pdf, dy): single-month log-growth density of a Gaussian market
    on a uniform y-grid covering +/- z_span sigmas of the normal."""
    a = 1.0 + mean_pct / 100.0
    b = std_pct / 100.0
    if a - z_span * b <= 0:
        raise ValueError(
            "log-growth undefined: P(growth <= 0) is non-negligible for "
            f"mean={mean_pct}, std={std_pct}"
        )
    y_lo = np.log(a - z_span * b)
    y_hi = np.log(a + z_span * b)
    y = np.linspace(y_lo, y_hi, n_grid)
    dy = y[1] - y[0]
    ey = np.exp(y)
    z = (ey - a) / b
    pdf = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi) * ey / b
    pdf /= pdf.sum() * dy
    return y, pdf, dy


def _convolve_log_pmf(p_mass, y_lo: float, dy: float, t: int,
                      initial_capital: float):
    """(values, cdf) of V_T = v0 * exp(sum of t iid draws) whose single-
    draw log-mass is ``p_mass`` on the uniform grid y_lo + dy*k."""
    n_grid = len(p_mass)
    total_width = dy * (n_grid - 1) * t
    n_total = int(2 ** np.ceil(np.log2(total_width / dy + n_grid)))
    pm = np.zeros(n_total)
    pm[:n_grid] = p_mass
    chf = np.fft.rfft(pm)
    conv = np.fft.irfft(chf ** t, n=n_total)
    conv = np.maximum(conv, 0.0)
    conv /= conv.sum()
    # grid of the sum: starts at t*y_lo, spacing dy
    log_v = np.log(initial_capital) + t * y_lo + dy * np.arange(n_total)
    return np.exp(log_v), np.cumsum(conv)


@lru_cache(maxsize=16)
def final_value_distribution(mean_pct: float, std_pct: float,
                             n_periods: int, initial_capital: float,
                             n_grid: int = 1 << 14):
    """(values, cdf): exact distribution of V_T under the Gaussian market,
    on a log grid (cached per parameter tuple)."""
    y, pdf, dy = log_growth_pdf_grid(mean_pct, std_pct, n_grid)
    return _convolve_log_pmf(pdf * dy, y[0], dy, n_periods,
                             initial_capital)


def bootstrap_final_value_distribution(returns_pct, n_periods: int,
                                       initial_capital: float = 1000.0,
                                       n_grid: int = 1 << 15):
    """(values, cdf): the exact iid-bootstrap law of V_T over the table.
    All table entries must satisfy 1 + r/100 > 0."""
    p, y_lo, dy = _table_log_pmf(returns_pct, n_grid)
    return _convolve_log_pmf(p, y_lo, dy, n_periods, initial_capital)


def _table_log_pmf(returns_pct, n_grid: int):
    """(p_mass, y_lo, dy): the table's 1/n log-growth point masses
    deposited on a uniform y-grid with linear (mean-preserving)
    splitting."""
    r = np.asarray(returns_pct, np.float64) * 0.01
    g = 1.0 + r
    if np.any(g <= 0):
        raise ValueError("table has a month with growth <= 0; "
                         "log-growth undefined")
    y_i = np.log(g)
    y_lo, y_hi = y_i.min(), y_i.max()
    pad = max((y_hi - y_lo) * 1e-3, 1e-9)
    y_lo -= pad
    y_hi += pad
    dy = (y_hi - y_lo) / (n_grid - 1)
    pos = (y_i - y_lo) / dy
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    p = np.zeros(n_grid)
    w = 1.0 / len(y_i)
    np.add.at(p, i0, w * (1.0 - frac))
    np.add.at(p, i0 + 1, w * frac)
    return p, y_lo, dy


def marginal_value_quantiles(kind: str, params, n_periods: int,
                             initial_capital: float, qs: Sequence[float],
                             keep=None, n_grid: int = 1 << 13
                             ) -> np.ndarray:
    """(len(qs), T+1) exact per-month marginal quantiles of V_t, the
    infinite-path limit of the empirical trajectory bands.

    One forward FFT of the single-month log-growth pmf, then T incremental
    characteristic-function multiplies and inverse FFTs on a wraparound
    grid centred at the analytic month mean, spanning ~80 sigma of the
    longest horizon. ``kind``: "gaussian" with params (mean_pct, std_pct),
    or "bootstrap" with params = returns_pct table. ``keep``: optional (T,)
    multiplicative keep fractions (> 0), which shift month t's marginal by
    sum_{s<=t} log keep_s.
    """
    if kind == "gaussian":
        mean_pct, std_pct = params
        y, pdf, dy = log_growth_pdf_grid(float(mean_pct), float(std_pct),
                                         n_grid)
        p_mass = pdf * dy
        y_lo = y[0]
        y_span = y[-1] - y[0]
    elif kind == "bootstrap":
        p_mass, y_lo, dy = _table_log_pmf(params, n_grid)
        y_span = dy * (n_grid - 1)
    else:
        raise ValueError(f"kind must be gaussian|bootstrap, got {kind!r}")

    grid_y = y_lo + dy * np.arange(n_grid)
    mu_y = float(np.sum(p_mass * grid_y))
    var_y = float(np.sum(p_mass * (grid_y - mu_y) ** 2))
    t_max = int(n_periods)
    total_width = max(80.0 * np.sqrt(var_y * t_max), 4.0 * y_span)
    n_total = int(2 ** np.ceil(np.log2(total_width / dy)))
    ref_cell = int(np.round((mu_y - y_lo) / dy))
    pm = np.zeros(n_total)
    np.add.at(pm, (np.arange(n_grid) - ref_cell) % n_total, p_mass)
    chf = np.fft.rfft(pm)

    if keep is not None:
        keep = np.asarray(keep, np.float64)
        if np.any(keep <= 0.0):
            raise ValueError("keep fractions must be > 0 for the "
                             "analytic marginal law")
        log_keep_cum = np.cumsum(np.log(keep))
    qs_arr = np.asarray(list(qs))
    out = np.empty((len(qs_arr), t_max + 1))
    out[:, 0] = initial_capital
    offs = (np.arange(n_total) - n_total // 2) * dy
    chf_acc = np.ones(n_total // 2 + 1, dtype=complex)
    for t in range(1, t_max + 1):
        chf_acc = chf_acc * chf
        conv = np.maximum(np.fft.irfft(chf_acc, n=n_total), 0.0)
        conv /= conv.sum()
        cdf = np.cumsum(np.fft.fftshift(conv))
        shift = log_keep_cum[t - 1] if keep is not None else 0.0
        log_v0 = float(np.log(initial_capital)) + t * (
            y_lo + ref_cell * dy) + shift
        j = np.searchsorted(cdf, qs_arr)
        j = np.clip(j, 1, n_total - 1)
        c0, c1 = cdf[j - 1], cdf[j]
        frac = np.where(c1 > c0, (qs_arr - c0) / np.maximum(c1 - c0,
                                                            1e-300), 0.5)
        out[:, t] = np.exp(log_v0 + offs[j - 1] + frac * dy)
    return out
