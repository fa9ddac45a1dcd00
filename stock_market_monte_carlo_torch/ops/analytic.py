"""Exact value laws by FFT convolution (numpy, float64): the oracles the
terminal-law fit samples from, the per-month marginals of the analytic
bands, and the laws the long-run validations hold the samplers to.

Counterpart of ``stock_market_monte_carlo_tpu.ops.analytic``, with the
same arithmetic, so the fitted operand, the bands and the oracles are
bit-identical. log V_T is a T-fold convolution of the single-month
log-growth law; it runs as irfft(rfft(p)^T) on a grid padded so the full
T-month support fits without wraparound (or, for the CLT sampler's law,
on a wraparound grid wide enough that the folded mass is negligible).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# The CLT sampler's law. Its month z is a weighted sum of 128 iid uniforms
# mixed through the vendored bf16 orthogonal Q (``ops/clt.py``): z_j =
# sum_i w_ij x_i, x ~ U(-1/2, 1/2), w_ij = q_ij * s / ||q_j||, s =
# sqrt(12 / (1 - 2^-32)), mean 0 and variance 1 with per-column excess
# kurtosis -(1/120) sum_i w_ij^4. Its characteristic function is
# prod_i sinc(w_i t / 2); the month log-growth convolves over the horizon.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def clt_column_weights() -> np.ndarray:
    """(128 uniforms, 128 columns) float64 mixing weights of the CLT
    sampler, from the same vendored bf16 Q the kernel multiplies by."""
    from stock_market_monte_carlo_torch.ops import clt

    q = clt.q_tensor("cpu").to(torch.float64).numpy()
    colnorm = np.sqrt((q**2).sum(axis=0))
    s = np.sqrt(12.0 / (1.0 - 2.0**-32))
    return q * (s / colnorm)[None, :]


def clt_z_pdf(weights, n_grid: int = 1 << 14, span: float = 24.0):
    """(x, pdf): density of z = sum_i w_i x_i, x ~ U(-1/2,1/2) iid, by
    inverse FFT of the product-of-sinc characteristic function."""
    w = np.asarray(weights, np.float64)
    dx = 2.0 * span / n_grid
    k = np.arange(n_grid // 2 + 1)
    t = 2.0 * np.pi * k / (n_grid * dx)
    arg = np.outer(w, t) / 2.0
    sc = np.ones_like(arg)
    nz = np.abs(arg) > 1e-300
    sc[nz] = np.sin(arg[nz]) / arg[nz]
    phi = sc.prod(axis=0)
    pdf = np.fft.irfft(phi * np.exp(-1j * t * (-span)), n=n_grid) / dx
    return -span + dx * np.arange(n_grid), np.maximum(pdf, 0.0)


@lru_cache(maxsize=8)
def clt_final_value_distribution(mean_pct: float, std_pct: float,
                                 n_periods: int, initial_capital: float,
                                 n_grid: int = 1 << 13,
                                 law: str = "clt"):
    """(values, cdf): the final-value distribution under ``law``, months
    treated as independent.

    ``law='clt'`` uses the CLT sampler's per-column z densities (month t
    draws column t mod 128 of a fresh block); ``law='normal'`` runs the
    exact standard normal through the same grid and FFT, so the difference
    of the two is the marginal law's deviation with the grid's artifacts
    cancelled. The sampler's months within one block share a draw and are
    not independent: that 4th-order correction (~0.4 % at p = 1e-5) is
    ``clt_block_kurtosis`` / ``clt_tail_deviation``.

    The T-fold convolution runs on a grid centred at the analytic month
    mean with wraparound, ~40 total sigmas wide, so the folded mass is
    below ~1e-290.
    """
    if law not in ("clt", "normal"):
        raise ValueError(f"unknown law {law!r}")
    a = 1.0 + mean_pct / 100.0
    b = std_pct / 100.0
    zspan = 16.0
    if a - zspan * b <= 0:
        raise ValueError(
            "log-growth undefined for the CLT-law oracle: "
            f"mean={mean_pct}, std={std_pct}"
        )
    y_lo, y_hi = np.log(a - zspan * b), np.log(a + zspan * b)
    y = np.linspace(y_lo, y_hi, n_grid)
    dy = y[1] - y[0]
    ey = np.exp(y)
    zy = (ey - a) / b

    t = n_periods
    sigma_y = b / a  # ~std of one month's log growth
    total_width = max(80.0 * sigma_y * np.sqrt(t), 4.0 * (y_hi - y_lo))
    n_total = int(2 ** np.ceil(np.log2(total_width / dy)))
    # each month's pdf centred at the grid cell nearest its mean, negative
    # offsets wrapped to the top of the array
    mu_y = float(np.log(a) - 0.5 * (b / a) ** 2)
    ref_cell = int(np.round((mu_y - y_lo) / dy))

    def month_chf(pz):
        py = pz * ey / b
        py /= py.sum() * dy
        p = np.zeros(n_total)
        idx = (np.arange(n_grid) - ref_cell) % n_total
        np.add.at(p, idx, py * dy)
        return np.fft.rfft(p)

    if law == "normal":
        pzn = np.exp(-0.5 * zy * zy) / np.sqrt(2.0 * np.pi)
        chf_total = month_chf(pzn) ** t
    else:
        weights = clt_column_weights()
        mult = np.bincount(np.arange(t) % 128, minlength=128)
        chf_total = np.ones(n_total // 2 + 1, dtype=complex)
        for j in range(128):
            if mult[j] == 0:
                continue
            xz, pz_grid = clt_z_pdf(weights[:, j])
            chf_total *= month_chf(np.interp(zy, xz, pz_grid)) ** int(
                mult[j]
            )

    conv = np.maximum(np.fft.irfft(chf_total, n=n_total), 0.0)
    conv /= conv.sum()
    # unwrap: cell m is offset (m <= n/2 ? m : m - n) * dy from t*center
    conv = np.fft.fftshift(conv)
    offs = (np.arange(n_total) - n_total // 2) * dy
    log_v = (np.log(initial_capital) + t * (y_lo + ref_cell * dy)) + offs
    return np.exp(log_v), np.cumsum(conv)


def clt_block_kurtosis(mean_pct: float, std_pct: float,
                       n_periods: int) -> float:
    """Excess kurtosis gamma2 of log V_T under the CLT sampler's shared-draw
    blocks.

    The 128 month z's of a block are mixed from one 128-uniform draw:
    uncorrelated but not independent, Cov(z_i^2, z_j^2) = kappa4(u) /
    Var(u)^2 * sum_k w~_ki^2 w~_kj^2 (~ -1.2/128 a pair), and the ~C(128,2)
    same-block month pairs add 3 * sum Cov(y_i^2, y_j^2) to kappa4(log
    V_T), ~130x the marginal per-column term that
    ``clt_final_value_distribution`` captures.
    """
    w = clt_column_weights()
    wt2 = w**2 / 12.0                      # per-column sums = 1
    cross_cols = -1.2 * (wt2.T @ wt2)      # Cov(z_i^2, z_j^2) matrix
    own_cols = np.diag(cross_cols).copy()
    np.fill_diagonal(cross_cols, 0.0)

    t = n_periods
    mult = np.bincount(np.arange(t) % 128, minlength=128)
    beta = (std_pct / 100.0) / (1.0 + mean_pct / 100.0)
    # same-block pairs: full blocks use all 128 columns, the tail block
    # the first t mod 128
    n_full, rem = divmod(t, 128)
    pair_sum = n_full * float(cross_cols.sum())
    if rem:
        pair_sum += float(cross_cols[:rem, :rem].sum())
    own = float((mult * own_cols).sum())
    k4 = beta**4 * (own + 3.0 * pair_sum)
    sigma2 = t * beta**2
    return float(k4 / sigma2**2)


def clt_tail_deviation(p: float, mean_pct: float, std_pct: float,
                       n_periods: int) -> float:
    """Predicted relative deviation of the CLT sampler's p-quantile of V_T
    from the independent-month law (Cornish-Fisher, leading order in
    ``clt_block_kurtosis``): positive in the lower tail, negative in the
    upper. ~+4e-3 at p = 1e-5 for the default market at 360 months. z is
    the float32 normal quantile of ``ops/normal.py``, as the JAX package
    takes it."""
    from stock_market_monte_carlo_torch.ops.normal import normal_icdf

    g2 = clt_block_kurtosis(mean_pct, std_pct, n_periods)
    beta = (std_pct / 100.0) / (1.0 + mean_pct / 100.0)
    sigma = float(np.sqrt(n_periods) * beta)
    z = float(normal_icdf(np.float32(p)))
    return sigma * (g2 / 24.0) * (z**3 - 3.0 * z)


def quantiles_from_cdf(values, cdf, qs) -> np.ndarray:
    """Log-interpolated quantiles from a (values, cdf) grid pair."""
    out = np.empty(len(qs))
    logv = np.log(values)
    for i, q in enumerate(qs):
        j = int(np.searchsorted(cdf, q))
        j = min(max(j, 1), len(cdf) - 1)
        c0, c1 = cdf[j - 1], cdf[j]
        frac = (q - c0) / (c1 - c0) if c1 > c0 else 0.5
        out[i] = np.exp(logv[j - 1] + frac * (logv[j] - logv[j - 1]))
    return out


def final_value_quantiles(mean_pct: float, std_pct: float, n_periods: int,
                          initial_capital: float,
                          qs: Sequence[float]) -> np.ndarray:
    return quantiles_from_cdf(*final_value_distribution(
        mean_pct, std_pct, n_periods, initial_capital
    ), qs)


def final_value_moments(mean_pct: float, std_pct: float, n_periods: int,
                        initial_capital: float) -> Tuple[float, float]:
    """(mean, std) of V_T in closed form: E[V] = V0 m1^T, E[V^2] = V0^2
    (m1^2 + s^2)^T."""
    m1 = 1.0 + mean_pct / 100.0
    s = std_pct / 100.0
    mean = initial_capital * m1 ** n_periods
    second = initial_capital**2 * (m1 * m1 + s * s) ** n_periods
    return mean, float(np.sqrt(second - mean * mean))


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
