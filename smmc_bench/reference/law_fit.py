"""The terminal law's operand: the fitted quantile function of V_T under
the i.i.d. bootstrap of a returns table, V(z) = scale * exp(C(z / 6.25)),
as the (49,) float32 array [scale, c_0 .. c_47] the law's draw reads.

Frozen copy, at commit 9db0996, of ``fit_terminal_law`` (its bootstrap
branch without a withdrawal), ``_qlog_of_z`` and ``clenshaw_f32`` from
``stock_market_monte_carlo_torch/ops/terminal_law.py``, and of
``bootstrap_final_value_distribution``, ``_table_log_pmf`` and
``_convolve_log_pmf`` from ``ops/analytic.py``; ``norm_icdf64`` is
``reference/inversion.py``'s frozen copy of ``ops/reductions.py``'s.
numpy, float64 but for the float32 operand and its validation; nothing
here imports the port.
"""

from __future__ import annotations

import numpy as np

from smmc_bench.reference.inversion import norm_icdf64

LAW_ZMAX = 6.25
LAW_CLAMP = 5.99
LAW_D = 48
# the fit's largest log error over |z| <= LAW_CLAMP
LAW_TOL = 2e-4


def _table_log_pmf(returns_pct, n_grid: int):
    """(p_mass, y_lo, dy): the table's 1/n log-growth point masses on a
    uniform y-grid, each split linearly between its two nodes."""
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


def _convolve_log_pmf(p_mass, y_lo: float, dy: float, t: int,
                      initial_capital: float):
    """(values, cdf) of V_T = v0 * exp(sum of t i.i.d. draws of log-mass
    ``p_mass`` on the grid y_lo + dy*k): irfft(rfft(p)^t) on a grid wide
    enough that nothing wraps."""
    n_grid = len(p_mass)
    total_width = dy * (n_grid - 1) * t
    n_total = int(2 ** np.ceil(np.log2(total_width / dy + n_grid)))
    pm = np.zeros(n_total)
    pm[:n_grid] = p_mass
    conv = np.fft.irfft(np.fft.rfft(pm) ** t, n=n_total)
    conv = np.maximum(conv, 0.0)
    conv /= conv.sum()
    log_v = np.log(initial_capital) + t * y_lo + dy * np.arange(n_total)
    return np.exp(log_v), np.cumsum(conv)


def bootstrap_final_value_distribution(returns_pct, n_periods: int,
                                       initial_capital: float,
                                       n_grid: int = 1 << 15):
    """(values, cdf): the exact i.i.d.-bootstrap law of V_T."""
    p, y_lo, dy = _table_log_pmf(returns_pct, n_grid)
    return _convolve_log_pmf(p, y_lo, dy, n_periods, initial_capital)


def clenshaw_f32(coefs, s):
    """The Chebyshev series at ``s`` by Clenshaw's recurrence in float32,
    in the order the law's draw runs it."""
    c = np.asarray(coefs, np.float32)
    s = np.asarray(s, np.float32)
    two_s = np.float32(2.0) * s
    b1 = np.zeros_like(s)
    b2 = np.zeros_like(s)
    for k in range(len(c) - 1, 0, -1):
        b0 = two_s * b1 - b2 + c[k]
        b2 = b1
        b1 = b0
    return s * b1 - b2 + c[0]


def _qlog_of_z(values, cdf, z):
    """log-quantile of the (values, cdf) law at probit positions ``z``,
    linear in probit space between the oracle's grid points."""
    logv = np.log(values)
    mask = (cdf > 1e-300) & (cdf < 1.0 - 1e-16)
    c = cdf[mask]
    lv = logv[mask]
    keep = np.concatenate([[True], np.diff(c) > 0])
    c = c[keep]
    lv = lv[keep]
    if len(c) < 8:
        raise ValueError("terminal law oracle grid degenerate")
    return np.interp(z, norm_icdf64(c), lv)


def law_operand(returns_pct, n_periods: int,
                initial_capital: float) -> np.ndarray:
    """(LAW_D + 1,) float32 [scale, c_0 .. c_{LAW_D-1}] of the bootstrap
    law of ``returns_pct`` (float64) over ``n_periods`` months from
    ``initial_capital``: a least-squares Chebyshev fit of the oracle's
    log-quantile at 8 * LAW_D Chebyshev-Lobatto nodes in z, its mean
    level split off as the float64 scale. Raises ValueError where the
    float32 series misses the oracle by more than LAW_TOL in log space."""
    values, cdf = bootstrap_final_value_distribution(
        returns_pct, int(n_periods), float(initial_capital))
    n_nodes = 8 * LAW_D
    zs = LAW_ZMAX * np.cos(np.pi * np.arange(n_nodes) / (n_nodes - 1))
    q = _qlog_of_z(values, cdf, zs)
    coef = np.polynomial.chebyshev.chebfit(zs / LAW_ZMAX, q, LAW_D - 1)
    scale = float(np.exp(coef[0]))
    coef = coef.copy()
    coef[0] = 0.0
    coefs32 = coef.astype(np.float32)

    zval = np.linspace(-LAW_CLAMP, LAW_CLAMP, 4097)
    s32 = zval.astype(np.float32) * np.float32(1.0 / LAW_ZMAX)
    got = clenshaw_f32(coefs32, s32)
    want = _qlog_of_z(values, cdf, zval) - np.log(scale)
    max_err = float(np.max(np.abs(got.astype(np.float64) - want)))
    if not np.isfinite(max_err) or max_err > LAW_TOL:
        raise ValueError(f"terminal law fit error {max_err:.2e} exceeds "
                         f"{LAW_TOL:.0e} at T={n_periods}")
    return np.concatenate([np.float32([scale]), coefs32]).astype(np.float32)
