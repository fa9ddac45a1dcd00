"""Market models: where monthly percent returns come from.

Frozen dataclasses over numpy/float fields, with the JAX package's names
and ``kind`` tags. Returns are in percent per month; a month compounds as
``V *= (100 + r) / 100``. Bootstrap draws are i.i.d. uniform over table
rows, with replacement.

The kernels sample the counter stream (``rng="counter"``): the JAX
package's arithmetic stream (``SMMC_PRNG_IMPL=arith``). Trajectories
(``engine.sample_growth``) draw from the threefry stream through
``sample_returns_pct``, as the JAX package's XLA paths do. The
reference-parity stream (``rng="reference"``) and the Sobol models are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from stock_market_monte_carlo_torch.config import (
    DEFAULT_GAUSSIAN_MEAN_PCT,
    DEFAULT_GAUSSIAN_STD_PCT,
)


@dataclasses.dataclass(frozen=True)
class GaussianReturns:
    """Monthly returns ~ N(mean_pct, std_pct), in percent."""

    mean_pct: float = DEFAULT_GAUSSIAN_MEAN_PCT
    std_pct: float = DEFAULT_GAUSSIAN_STD_PCT

    kind = "gaussian"

    def sample_returns_pct(self, key, shape) -> torch.Tensor:
        """float32 returns of ``shape`` per key of the batch ``key``:
        mean + std * ``jax.random.normal``, in float32."""
        from stock_market_monte_carlo_torch.ops import threefry

        return (float(np.float32(self.mean_pct))
                + float(np.float32(self.std_pct))
                * threefry.normal(key, shape))


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

    def sample_returns_pct(self, key, shape) -> torch.Tensor:
        """float32 returns of ``shape`` per key of the batch ``key``: table
        rows drawn by ``jax.random.randint``, looked up by a gather."""
        from stock_market_monte_carlo_torch.ops import threefry

        table = torch.tensor(self.returns_pct, device=key[0].device)
        return table[threefry.randint(key, shape, 0, table.shape[0])]


MarketModel = Union[GaussianReturns, HistoricalBootstrap]
