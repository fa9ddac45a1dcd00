"""Result container and pretty-printing (unchanged in behaviour from the
JAX package's ``engine/results.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from stock_market_monte_carlo_torch.ops.reductions import (
    HistogramSpec,
    MomentSummary,
    prob_below_from_histogram,
    quantiles_from_histogram,
)

DEFAULT_QUANTILES = (0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99)


@dataclasses.dataclass
class SimulationResult:
    n_paths: int
    n_periods: int
    initial_capital: float
    moments: MomentSummary
    histogram_spec: Optional[HistogramSpec] = None
    histogram_counts: Optional[np.ndarray] = None  # (n_bins+2,) with under/overflow
    target_amount: Optional[float] = None
    final_values: Optional[np.ndarray] = None
    trajectories: Optional[np.ndarray] = None  # (paths_kept, n_periods+1)
    elapsed_s: Optional[float] = None

    @property
    def mean(self) -> float:
        return self.moments.mean

    @property
    def std(self) -> float:
        return self.moments.std

    @property
    def count_below(self) -> Optional[int]:
        return self.moments.count_below

    @property
    def prob_below(self) -> Optional[float]:
        if self.moments.count_below is None:
            return None
        return self.moments.count_below / self.n_paths

    def prob_below_amount(self, amount: float) -> float:
        """P(final value < amount): exact from kept finals, else
        interpolated from the histogram (one log-space bin of error)."""
        if self.final_values is not None:
            return float((self.final_values < amount).mean())
        if self.histogram_counts is None:
            raise ValueError("no histogram or finals available")
        return prob_below_from_histogram(
            self.histogram_spec, self.histogram_counts, amount
        )

    def quantiles(self, qs=DEFAULT_QUANTILES) -> Dict[float, float]:
        """Quantiles: exact from final values when kept, else interpolated
        from the histogram."""
        qs = tuple(float(q) for q in np.atleast_1d(qs))
        if self.final_values is not None:
            vals = np.quantile(self.final_values, qs)
        elif self.histogram_counts is not None:
            vals = quantiles_from_histogram(
                self.histogram_spec, self.histogram_counts, qs
            )
        else:
            raise ValueError(
                "no final values or histogram available for quantiles"
            )
        return dict(zip(qs, (float(v) for v in vals)))

    def summary(self) -> str:
        m = self.moments
        lines = [
            f"n_simulations: {self.n_paths}",
            f"n_periods: {self.n_periods}",
            f"initial_capital: {self.initial_capital:.1f}",
            f"mean: {m.mean:.2f} | std: {m.std:.2f}",
            f"min: {m.min:.2f} | max: {m.max:.2f}",
            f"skew: {m.skew:.3f} | kurtosis: {m.kurtosis:.3f}",
        ]
        if self.elapsed_s is not None:
            rate = self.n_paths / self.elapsed_s if self.elapsed_s else 0.0
            lines.append(
                f"All {self.n_paths} simulations done in "
                f"{self.elapsed_s:.3f} s! ({rate:,.0f} paths/s)"
            )
        if self.count_below is not None:
            pct = 100.0 * self.prob_below
            lines.append(
                f"count_below {self.target_amount:.1f}: "
                f"{self.count_below} ({pct:.4f}%)"
            )
        if self.histogram_counts is not None or self.final_values is not None:
            q = self.quantiles()
            qtxt = " | ".join(
                f"p{int(k * 100):02d}={v:.1f}" for k, v in sorted(q.items())
            )
            lines.append(f"quantiles: {qtxt}")
        if m.total_withdrawn:
            lines.append(f"total_withdrawn: {m.total_withdrawn:.2f}")
        return "\n".join(lines)
