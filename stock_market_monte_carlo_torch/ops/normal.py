"""Normal-distribution math kit on torch tensors.

Counterpart of ``stock_market_monte_carlo_tpu/ops/normal.py``: the
reference's host-side analytic helpers (``normalCDF`` via erfc, the
Abramowitz-Stegun CND, the normal pdf, the truncated-left CDF,
quantiles from mean and std and the CLT count below a target) and the
inverse normal CDF of the Sobol Gaussian model's trajectories.

The functions follow the JAX package's dtype rules: array inputs compute
in float32 on their own device; Python numbers stay Python floats until
the first transcendental, as JAX's weak types do, so ``count_below_clt``
of Python floats standardises in float64 and takes one float32 erfc.

The month-loop kernel maps a Sobol word to a normal through u23
(``cuda_engine._normal_z``); ``SobolGaussianReturns.sample_returns_pct_quasi``
maps it through ``sobol_points_f32`` (word * 2^-32, clamped below 1) and
``normal_icdf`` (clipped to [1e-7, 1 - 1e-7]). The two routes round the
uniform apart and stay apart, as in the JAX package.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from stock_market_monte_carlo_torch.ops.cuda_engine import _SQRT2, _erfinv_poly

_EPS = float(np.float32(1e-7))
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _f32(x):
    """A Python number as it is (JAX's weak type), anything else as a
    float32 tensor on its own device."""
    if isinstance(x, numbers.Real):
        return float(x)
    return torch.as_tensor(x, dtype=torch.float32)


def _tensor(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def normal_cdf(x, mean=0.0, std=1.0) -> torch.Tensor:
    """Phi((x - mean) / std) via erfc: the reference's ``normalCDF``."""
    z = (_f32(x) - _f32(mean)) / _f32(std)
    return 0.5 * torch.special.erfc(_tensor(-z * _INV_SQRT2))


def normal_cdf_abramowitz_stegun(d) -> torch.Tensor:
    """The reference's ``cumulative_normal_standard`` polynomial CND
    (Abramowitz & Stegun 26.2.17, |error| < 7.5e-8)."""
    d = _tensor(d)
    a1, a2, a3 = 0.31938153, -0.356563782, 1.781477937
    a4, a5 = -1.821255978, 1.330274429
    k = 1.0 / (1.0 + 0.2316419 * torch.abs(d))
    poly = k * (a1 + k * (a2 + k * (a3 + k * (a4 + k * a5))))
    cnd = _INV_SQRT_2PI * torch.exp(-0.5 * d * d) * poly
    return torch.where(d > 0, 1.0 - cnd, cnd)


def normal_pdf(x, mean=0.0, std=1.0) -> torch.Tensor:
    """The normal density (the reference's ``normal``)."""
    a = (_f32(x) - _f32(mean)) / _f32(std)
    return _INV_SQRT_2PI / _f32(std) * torch.exp(_tensor(-0.5 * a * a))


def truncated_normal_cdf_left(x, mean, std, lo) -> torch.Tensor:
    """CDF of a normal truncated to [lo, inf): the reference's
    truncated-left CDF, for runs that discard the mass below a floor."""
    num = normal_cdf(x, mean, std) - normal_cdf(lo, mean, std)
    den = 1.0 - normal_cdf(lo, mean, std)
    return torch.clamp(num / den, 0.0, 1.0)


def erfinv_f32(x) -> torch.Tensor:
    """Single-precision inverse error function: the branch-free polynomial
    in w = -log(1 - x^2) (``cuda_engine._erfinv_poly``; the JAX function's
    sqrt(max(w, 1e-30)) only changes the tail branch where w < 5 discards
    it)."""
    return _erfinv_poly(torch.as_tensor(x, dtype=torch.float32))


def normal_icdf(u, mean: float = 0.0, std: float = 1.0) -> torch.Tensor:
    """Inverse normal CDF of float32 uniforms, clipped to [1e-7, 1 - 1e-7]
    so that u = 0 gives no infinity: mean + std * sqrt(2) erfinv(2u - 1)."""
    u = torch.clamp(torch.as_tensor(u, dtype=torch.float32), _EPS,
                    float(np.float32(1.0) - np.float32(1e-7)))
    z = _SQRT2 * erfinv_f32(2.0 * u - 1.0)
    return _f32(mean) + _f32(std) * z


def quantiles_from_mean_std(qs, mean, std) -> torch.Tensor:
    """Normal-approximation quantiles from summary statistics."""
    return _f32(mean) + _f32(std) * normal_icdf(_tensor(qs))


def count_below_clt(target, mean, std, n) -> torch.Tensor:
    """CLT estimate of the paths below ``target`` from mean and std alone:
    the reference's ``update_count_below_min`` on its reduceBlock path.
    The final values are skewed, so this is an approximation; the engine
    counts the exact number on the device."""
    return _f32(n) * normal_cdf(target, mean, std)
