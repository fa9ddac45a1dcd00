"""Build the port's model or strategy from a JAX-package object.

Duck typing on ``kind`` and the field names, through ``np.asarray``: this
module imports neither jax nor the JAX package, so tests can hand both
packages the same inputs.
"""

from __future__ import annotations

import numpy as np

from stock_market_monte_carlo_torch.models.market import (
    GaussianReturns,
    HistoricalBootstrap,
    SobolGaussianReturns,
    SobolHistoricalBootstrap,
)
from stock_market_monte_carlo_torch.models.strategies import (
    FixedAmountWithdrawal,
    FixedPercentWithdrawal,
    NoWithdrawal,
    VariablePercentWithdrawal,
)


def from_reference(obj):
    """The port's counterpart of a JAX model or strategy ``obj``."""
    kind = getattr(obj, "kind", None)
    if kind == "gaussian":
        return GaussianReturns(mean_pct=float(np.asarray(obj.mean_pct)),
                               std_pct=float(np.asarray(obj.std_pct)))
    if kind == "historical":
        return HistoricalBootstrap(
            returns_pct=np.asarray(obj.returns_pct, np.float32),
            rng=getattr(obj, "rng", "counter"),
        )
    if kind == "none":
        return NoWithdrawal()
    if kind == "fixed_amount":
        return FixedAmountWithdrawal(amount=float(np.asarray(obj.amount)))
    if kind == "fixed_percent":
        return FixedPercentWithdrawal(percent=float(np.asarray(obj.percent)))
    if kind == "variable_percent":
        return VariablePercentWithdrawal(
            percent_schedule=np.asarray(obj.percent_schedule))
    if kind == "sobol_gaussian":
        return SobolGaussianReturns(
            direction=np.asarray(obj.direction, np.uint32),
            mean_pct=float(np.asarray(obj.mean_pct)),
            std_pct=float(np.asarray(obj.std_pct)),
            index_offset=int(obj.index_offset))
    if kind == "sobol_historical":
        return SobolHistoricalBootstrap(
            returns_pct=np.asarray(obj.returns_pct, np.float32),
            direction=np.asarray(obj.direction, np.uint32),
            index_offset=int(obj.index_offset))
    raise TypeError(f"no port counterpart for {type(obj).__name__} "
                    f"(kind={kind!r})")
