"""PyTorch / CUDA port of the Monte Carlo stock-market simulator.

The JAX package ``stock_market_monte_carlo_tpu`` is the reference; this
package runs the same main path on an NVIDIA GPU with hand-written CUDA
kernels (``csrc/``), and on the CPU with their plain PyTorch versions
(``EngineOptions(device="cpu")``). It samples the JAX package's arithmetic
counter stream, so a run here reproduces a JAX run under
``SMMC_PRNG_IMPL=arith``. It imports neither jax nor the JAX package.

Ported so far: ``simulate_stats`` / ``simulate_final_values`` /
``simulate`` / ``run`` on ``HistoricalBootstrap`` (the month loop), and
with ``EngineOptions(terminal_law=True)`` on Gaussian or historical models.
What is not ported raises ``NotImplementedError`` naming its ROADMAP item.
"""

from stock_market_monte_carlo_torch.config import (
    EngineOptions,
    SimulationConfig,
)
from stock_market_monte_carlo_torch.models.market import (
    GaussianReturns,
    HistoricalBootstrap,
    MarketModel,
)
from stock_market_monte_carlo_torch.models.strategies import (
    FixedAmountWithdrawal,
    FixedPercentWithdrawal,
    NoWithdrawal,
    VariablePercentWithdrawal,
    WithdrawalStrategy,
)
from stock_market_monte_carlo_torch.engine.engine import (
    StreamUpdate,
    rqmc_estimate,
    run,
    simulate,
    simulate_bands,
    simulate_final_values,
    simulate_stats,
)
from stock_market_monte_carlo_torch.engine.results import SimulationResult
from stock_market_monte_carlo_torch.data.loader import (
    default_returns_path,
    read_historical_returns,
)

__version__ = "0.1.0"

__all__ = [
    "EngineOptions",
    "SimulationConfig",
    "MarketModel",
    "GaussianReturns",
    "HistoricalBootstrap",
    "WithdrawalStrategy",
    "NoWithdrawal",
    "FixedAmountWithdrawal",
    "FixedPercentWithdrawal",
    "VariablePercentWithdrawal",
    "StreamUpdate",
    "simulate",
    "simulate_final_values",
    "simulate_stats",
    "run",
    "simulate_bands",
    "rqmc_estimate",
    "SimulationResult",
    "read_historical_returns",
    "default_returns_path",
]
