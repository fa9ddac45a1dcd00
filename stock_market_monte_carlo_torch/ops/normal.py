"""The inverse normal CDF of the Sobol Gaussian model's trajectories.

Counterpart of ``erfinv_f32`` and ``normal_icdf`` in
``stock_market_monte_carlo_tpu/ops/normal.py``. The month-loop kernel maps
a Sobol word to a normal through u23 (``cuda_engine._normal_z``);
``SobolGaussianReturns.sample_returns_pct_quasi`` maps it through
``sobol_points_f32`` (word * 2^-32, clamped below 1) and ``normal_icdf``
(clipped to [1e-7, 1 - 1e-7]). The two routes round the uniform apart and
stay apart, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from stock_market_monte_carlo_torch.ops.cuda_engine import _SQRT2, _erfinv_poly

_EPS = float(np.float32(1e-7))


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
    return float(np.float32(mean)) + float(np.float32(std)) * z
