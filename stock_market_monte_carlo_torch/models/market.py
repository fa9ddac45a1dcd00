"""Market models: where monthly percent returns come from.

Frozen dataclasses over numpy/float fields, with the JAX package's names
and ``kind`` tags. Returns are in percent per month; a month compounds as
``V *= (100 + r) / 100``. Bootstrap draws are i.i.d. uniform over table
rows, with replacement.

Streams, each drawn by the month-loop kernel (``csrc/month_loop.cu``) and,
for trajectories, by ``engine.sample_growth``, as in the JAX package:

- ``rng="counter"`` (default): the JAX package's arithmetic counter stream
  (``SMMC_PRNG_IMPL=arith``) in the kernels; the threefry stream through
  ``sample_returns_pct`` for trajectories, as the JAX package's XLA paths;
- ``HistoricalBootstrap(rng="reference")``: the reference CUDA kernel's
  per-path stream, state0 = pcg_hash(path + 1), one xorshift a month,
  row floor(n * state / 2^32), on every route (``ops/rng.py``);
- ``SobolGaussianReturns``, ``SobolHistoricalBootstrap``: month t is Sobol
  dimension t, path p sequence position ``index_offset + p``, scrambled by
  a per-seed digital shift (``ops/sobol.py``).

``is_quasi`` tells the engine which models draw Sobol points.
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
from stock_market_monte_carlo_torch.ops.cuda_engine import MASK32


@dataclasses.dataclass(frozen=True)
class GaussianReturns:
    """Monthly returns ~ N(mean_pct, std_pct), in percent."""

    mean_pct: float = DEFAULT_GAUSSIAN_MEAN_PCT
    std_pct: float = DEFAULT_GAUSSIAN_STD_PCT

    kind = "gaussian"
    is_quasi = False

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
    is_quasi = False

    def __post_init__(self):
        if self.rng not in ("counter", "reference"):
            raise ValueError(
                f"rng must be 'counter' or 'reference', got {self.rng!r}")
        object.__setattr__(self, "returns_pct", _table(self.returns_pct))

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

    def sample_returns_pct_reference(self, path_offset, shape,
                                     device=None) -> torch.Tensor:
        """(B, T) float32 returns of global paths [path_offset, path_offset
        + B) on the reference stream: path p draws ``xorshift_stream(p +
        1, T)`` and row ``bootstrap_index_exact`` of each word."""
        from stock_market_monte_carlo_torch.ops import rng as rng_ops

        b, t = shape
        gids = (int(path_offset) + torch.arange(b, device=device)) & MASK32
        bits = rng_ops.xorshift_stream((gids + 1) & MASK32, t)
        table = torch.tensor(self.returns_pct, device=device)
        return table[rng_ops.bootstrap_index_exact(bits, table.shape[0])]


def _table(returns_pct) -> np.ndarray:
    table = np.asarray(returns_pct, np.float32)
    if table.ndim != 1 or table.size == 0:
        raise ValueError(
            f"returns_pct must be a non-empty 1-D table, got shape "
            f"{table.shape}"
        )
    return table


def _directions(n_periods: int, index_offset: int) -> np.ndarray:
    """The direction table of a Sobol model: (n_periods, 64) hi32 words for
    a nonzero ``index_offset``, else (n_periods, 32)."""
    from stock_market_monte_carlo_torch.ops import sobol

    return (sobol.direction_numbers_hi32(n_periods) if index_offset
            else sobol.direction_numbers(n_periods))


def _direction_field(direction) -> np.ndarray:
    direction = np.asarray(direction, np.uint32)
    if direction.ndim != 2 or direction.shape[1] not in (32, 64):
        raise ValueError(
            f"direction must be a (dims, 32) or (dims, 64) uint32 table, got "
            f"shape {direction.shape}"
        )
    return direction


@dataclasses.dataclass(frozen=True)
class SobolGaussianReturns:
    """Monthly returns ~ N(mean_pct, std_pct) from scrambled Sobol points:
    month t is dimension t, path p sequence position ``index_offset + p``
    (below 2^62; a nonzero offset needs the (dims, 64) table that
    ``create(..., index_offset=...)`` builds)."""

    direction: np.ndarray  # (dims, 32) or (dims, 64) uint32
    mean_pct: float = DEFAULT_GAUSSIAN_MEAN_PCT
    std_pct: float = DEFAULT_GAUSSIAN_STD_PCT
    index_offset: int = 0

    kind = "sobol_gaussian"
    is_quasi = True

    def __post_init__(self):
        object.__setattr__(self, "direction",
                           _direction_field(self.direction))

    @classmethod
    def create(cls, n_periods, mean_pct=DEFAULT_GAUSSIAN_MEAN_PCT,
               std_pct=DEFAULT_GAUSSIAN_STD_PCT,
               index_offset: int = 0) -> "SobolGaussianReturns":
        return cls(direction=_directions(n_periods, index_offset),
                   mean_pct=mean_pct, std_pct=std_pct,
                   index_offset=index_offset)

    def sample_returns_pct_quasi(self, scramble_key, path_offset, shape):
        """(B, T) float32 returns of paths [path_offset, path_offset + B):
        ``sobol_points_f32``, then ``normal_icdf``, then mean + std * z."""
        from stock_market_monte_carlo_torch.ops.normal import normal_icdf
        from stock_market_monte_carlo_torch.ops.sobol import sobol_points_f32

        n_paths, n_periods = shape
        u = sobol_points_f32(self.direction, path_offset, n_paths, n_periods,
                             scramble_key, self.index_offset)
        return (float(np.float32(self.mean_pct))
                + float(np.float32(self.std_pct)) * normal_icdf(u))


@dataclasses.dataclass(frozen=True)
class SobolHistoricalBootstrap:
    """Historical bootstrap from scrambled Sobol words: month t's row is
    floor(n * word / 2^32) of dimension t (the exact integer map on the
    word, not on a rounded uniform)."""

    returns_pct: np.ndarray
    direction: np.ndarray
    index_offset: int = 0

    kind = "sobol_historical"
    is_quasi = True

    def __post_init__(self):
        object.__setattr__(self, "returns_pct", _table(self.returns_pct))
        object.__setattr__(self, "direction",
                           _direction_field(self.direction))

    @classmethod
    def create(cls, returns_pct, n_periods,
               index_offset: int = 0) -> "SobolHistoricalBootstrap":
        return cls(returns_pct=returns_pct,
                   direction=_directions(n_periods, index_offset),
                   index_offset=index_offset)

    def sample_returns_pct_quasi(self, scramble_key, path_offset, shape):
        """(B, T) float32 returns of paths [path_offset, path_offset + B):
        rows ``bootstrap_index_exact`` of ``sobol_bits_u32``."""
        from stock_market_monte_carlo_torch.ops.rng import (
            bootstrap_index_exact,
        )
        from stock_market_monte_carlo_torch.ops.sobol import sobol_bits_u32

        n_paths, n_periods = shape
        bits = sobol_bits_u32(self.direction, path_offset, n_paths, n_periods,
                              scramble_key, self.index_offset)
        table = torch.tensor(self.returns_pct, device=bits.device)
        return table[bootstrap_index_exact(bits, table.shape[0])]


MarketModel = Union[
    GaussianReturns,
    HistoricalBootstrap,
    SobolGaussianReturns,
    SobolHistoricalBootstrap,
]
