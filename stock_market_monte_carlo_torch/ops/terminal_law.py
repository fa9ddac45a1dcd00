"""Terminal-law sampler: draw V_T in one step from its exact law.

For iid-month multiplicative models (Gaussian or historical bootstrap,
optionally with a deterministic keep-fraction schedule) log V_T is a
T-fold convolution of the single-month log-growth law shifted by
sum_t log k_t. The FFT oracles of ``ops/analytic.py`` give that law; the
host fits its probit-space quantile function with a Chebyshev series, and
the device samples

    V = scale * exp( C(z / LAW_ZMAX) ),   z ~ N(0, 1)

with one random word and one Clenshaw recurrence per path
(``ops/cuda_engine.law_chunk``). The fit is numpy code identical to the
JAX package's ``ops/terminal_law.py``, so ``operand()`` is bit-identical
between the two packages.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from stock_market_monte_carlo_torch.ops import analytic
from stock_market_monte_carlo_torch.ops.reductions import norm_icdf64
from stock_market_monte_carlo_torch.utils.timing import spanned

# Chebyshev domain half-width in z (probit) space. 23-bit uniforms cannot
# reach past |z| ~ 5.54 (cuda_engine._u23_from_bits keeps 2u-1 strictly
# inside (-1, 1)); the fit is validated over |z| <= LAW_CLAMP.
LAW_ZMAX = 6.25
LAW_CLAMP = 5.99
# Fixed operand length: [scale, c_0 .. c_{LAW_D-1}], zero padded.
LAW_D = 48
LAW_OP_LEN = LAW_D + 1


@dataclasses.dataclass(frozen=True)
class TerminalLawFit:
    """Fitted quantile function V(z) = scale * exp(C(z / LAW_ZMAX)).

    ``coefs`` is the (LAW_D,) float32 Chebyshev series of log(V(z)/scale);
    ``max_err`` the measured sup|log error| of the float32 replica of the
    device arithmetic against the FFT oracle over |z| <= LAW_CLAMP.
    """

    scale: float
    coefs: np.ndarray
    max_err: float
    degree: int

    def operand(self) -> np.ndarray:
        """(LAW_OP_LEN,) float32 device operand: [scale, coefs...]."""
        return np.concatenate(
            [np.float32([self.scale]), self.coefs]
        ).astype(np.float32)


def clenshaw_f32(coefs: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Float32 Clenshaw evaluation of a Chebyshev series — the exact
    arithmetic the device paths run (validation replica)."""
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


def _qlog_of_z(values: np.ndarray, cdf: np.ndarray,
               z: np.ndarray) -> np.ndarray:
    """log-quantile of the (values, cdf) law at probit positions ``z``
    (probit-space linear interpolation on the oracle grid)."""
    logv = np.log(values)
    mask = (cdf > 1e-300) & (cdf < 1.0 - 1e-16)
    c = cdf[mask]
    lv = logv[mask]
    keep = np.concatenate([[True], np.diff(c) > 0])
    c = c[keep]
    lv = lv[keep]
    if len(c) < 8:
        raise ValueError("terminal law oracle grid degenerate")
    zc = norm_icdf64(c)
    return np.interp(z, zc, lv)


_FIT_CACHE: dict = {}


def _law_cache_key(model, keep, n_periods: int, v0: float):
    """``keep``: the strategy's (T,) float64 keep factors, or None."""
    kind = model.kind
    if kind == "gaussian":
        params = (float(np.asarray(model.mean_pct)),
                  float(np.asarray(model.std_pct)))
    else:
        tbl = np.asarray(model.returns_pct, np.float64)
        params = hashlib.sha256(tbl.tobytes()).hexdigest()
    keep_key = (None if keep is None
                else hashlib.sha256(keep.tobytes()).hexdigest())
    return (kind, params, int(n_periods), float(v0), keep_key)


def fit_terminal_law(model, strategy, n_periods: int,
                     initial_capital: float,
                     tol: float = 2e-4) -> TerminalLawFit:
    """Fit the terminal-value quantile function for one run config.

    Raises ValueError when the float32 replica cannot reproduce the FFT
    oracle to ``tol`` in log space over |z| <= LAW_CLAMP (e.g. a short-
    horizon bootstrap law, whose quantile function is a step function).
    Cached per (model params, keep schedule, T, v0, tol).
    """
    keep = None
    if strategy.kind != "none":
        from stock_market_monte_carlo_torch.engine.engine import (
            _keep_factors_np,
        )

        keep = _keep_factors_np(strategy, n_periods).astype(np.float64)

    key = (_law_cache_key(model, keep, n_periods, initial_capital),
           float(tol))
    hit = _FIT_CACHE.get(key)
    if hit is None:
        hit = _FIT_CACHE[key] = _fit(model, keep, n_periods,
                                     initial_capital, tol)
    return hit


@spanned("smmc.law_fit")
def _fit(model, keep, n_periods: int, initial_capital: float,
         tol: float) -> TerminalLawFit:
    """``fit_terminal_law`` on a cache miss: the FFT oracle, the Chebyshev
    fit and its float32 validation."""
    log_shift = 0.0
    if keep is not None:
        if np.any(keep <= 0.0):
            raise ValueError(
                "terminal_law needs keep fractions > 0 every month "
                "(a 100% withdrawal makes every final exactly 0 — "
                "no law to sample); use the month-loop engine"
            )
        log_shift = float(np.log(keep).sum())

    if model.kind == "gaussian":
        values, cdf = analytic.final_value_distribution(
            float(np.asarray(model.mean_pct)),
            float(np.asarray(model.std_pct)),
            int(n_periods), float(initial_capital),
        )
    else:
        values, cdf = analytic.bootstrap_final_value_distribution(
            np.asarray(model.returns_pct, np.float64),
            int(n_periods), float(initial_capital),
        )

    # Chebyshev-Lobatto nodes over the full fit domain (8x oversampled
    # least squares at degree LAW_D-1)
    n_nodes = 8 * LAW_D
    zs = LAW_ZMAX * np.cos(np.pi * np.arange(n_nodes) / (n_nodes - 1))
    q = _qlog_of_z(values, cdf, zs) + log_shift
    coef = np.polynomial.chebyshev.chebfit(zs / LAW_ZMAX, q, LAW_D - 1)

    # split the midrange level into a float64 host scale so the float32
    # residual series stays O(sigma_T * z) regardless of v0
    scale = float(np.exp(coef[0]))
    coef = coef.copy()
    coef[0] = 0.0
    coefs32 = coef.astype(np.float32)

    # validate the float32 device arithmetic against the oracle on the
    # reachable draw domain; the device computes s = f32(z) * f32(1/ZMAX)
    zval = np.linspace(-LAW_CLAMP, LAW_CLAMP, 4097)
    s32 = zval.astype(np.float32) * np.float32(1.0 / LAW_ZMAX)
    got = clenshaw_f32(coefs32, s32)
    want = (_qlog_of_z(values, cdf, zval) + log_shift) - np.log(scale)
    max_err = float(np.max(np.abs(got.astype(np.float64) - want)))
    if not np.isfinite(max_err) or max_err > tol:
        raise ValueError(
            f"terminal_law fit error {max_err:.2e} exceeds tol {tol:.0e} "
            f"for {model.kind} T={n_periods}: the terminal law is not "
            "smooth enough for a degree-47 Chebyshev quantile function "
            "(typical cause: a short-horizon bootstrap law, which is a "
            "step function) — use the month-loop engine instead"
        )

    # degree threshold relative to the (log-space) coefficient magnitudes
    c_mag = float(np.max(np.abs(coefs32))) if coefs32.size else 0.0
    nz = np.nonzero(np.abs(coefs32) > 1e-7 * max(c_mag, 1e-30))[0]
    degree = int(nz[-1]) if len(nz) else 0
    return TerminalLawFit(scale=scale, coefs=coefs32, max_err=max_err,
                          degree=degree)
