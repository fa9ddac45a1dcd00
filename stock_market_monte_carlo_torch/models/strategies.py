"""Withdrawal strategies: the per-month rule applied after growth.

    V_{t+1} = clamp( V_t * g_t  -  withdrawal(V_t * g_t, t) , 0 )

Frozen dataclasses with the JAX package's names, ``kind`` tags and
validation. The kernels take the multiplicative strategies as a float32
keep factor per month, built once on the host by
``engine._keep_factors_np``; ``fixed_amount`` runs as
``max(grown - amount, 0)``.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np


def _validate_percent(p, what: str) -> None:
    """Reject percent outside [0, 100]: above 100 the keep factor would
    be negative; exactly 100 depletes the fund."""
    vals = np.asarray(p, dtype=np.float64)
    if vals.size and (np.any(vals < 0.0) or np.any(vals > 100.0)):
        raise ValueError(f"{what} must be within [0, 100], got {p}")


@dataclasses.dataclass(frozen=True)
class NoWithdrawal:
    """Pure compounding."""

    kind = "none"


@dataclasses.dataclass(frozen=True)
class FixedAmountWithdrawal:
    """Withdraw a fixed currency amount every period (clamped at depletion)."""

    amount: float

    kind = "fixed_amount"


@dataclasses.dataclass(frozen=True)
class FixedPercentWithdrawal:
    """Withdraw a fixed percentage of the fund every period."""

    percent: float

    kind = "fixed_percent"

    def __post_init__(self):
        _validate_percent(self.percent, "FixedPercentWithdrawal.percent")


@dataclasses.dataclass(frozen=True)
class VariablePercentWithdrawal:
    """Withdraw percent_schedule[t] percent of the fund in period t; the
    schedule must cover every period of the run."""

    percent_schedule: np.ndarray

    kind = "variable_percent"

    def __post_init__(self):
        _validate_percent(
            self.percent_schedule, "VariablePercentWithdrawal schedule"
        )


WithdrawalStrategy = Union[
    NoWithdrawal,
    FixedAmountWithdrawal,
    FixedPercentWithdrawal,
    VariablePercentWithdrawal,
]
