"""Market models: where monthly percent returns come from.

Frozen dataclasses over numpy/float fields, with the JAX package's names
and ``kind`` tags. Returns are in percent per month; a month compounds as
``V *= (100 + r) / 100``. Bootstrap draws are i.i.d. uniform over table
rows, with replacement.

The port samples only the counter stream (``rng="counter"``): the JAX
package's arithmetic stream (``SMMC_PRNG_IMPL=arith``). The reference-parity
stream (``rng="reference"``) and the Sobol models are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

from stock_market_monte_carlo_torch.config import (
    DEFAULT_GAUSSIAN_MEAN_PCT,
    DEFAULT_GAUSSIAN_STD_PCT,
)


@dataclasses.dataclass(frozen=True)
class GaussianReturns:
    """Monthly returns ~ N(mean_pct, std_pct), in percent.

    In this port a Gaussian model runs only with
    ``EngineOptions(terminal_law=True)``; the month-loop ICDF kernel is
    ROADMAP queue 1 item 7.
    """

    mean_pct: float = DEFAULT_GAUSSIAN_MEAN_PCT
    std_pct: float = DEFAULT_GAUSSIAN_STD_PCT

    kind = "gaussian"


@dataclasses.dataclass(frozen=True)
class HistoricalBootstrap:
    """i.i.d. bootstrap (with replacement) from a monthly-returns table.

    ``returns_pct`` is the ``returns`` column of the S&P500 CSV, in percent,
    held as a float32 numpy array.
    """

    returns_pct: np.ndarray
    rng: str = "counter"

    kind = "historical"

    def __post_init__(self):
        if self.rng != "counter":
            raise NotImplementedError(
                f"HistoricalBootstrap(rng={self.rng!r}): the port samples "
                "only the counter stream; the reference-parity stream is "
                "ROADMAP queue 1 item 12"
            )
        table = np.asarray(self.returns_pct, np.float32)
        if table.ndim != 1 or table.size == 0:
            raise ValueError(
                f"returns_pct must be a non-empty 1-D table, got shape "
                f"{table.shape}"
            )
        object.__setattr__(self, "returns_pct", table)

    @classmethod
    def from_csv(cls, path=None, rng: str = "counter") -> "HistoricalBootstrap":
        from stock_market_monte_carlo_torch.data.loader import (
            read_historical_returns,
        )

        return cls(returns_pct=read_historical_returns(path), rng=rng)


MarketModel = Union[GaussianReturns, HistoricalBootstrap]
