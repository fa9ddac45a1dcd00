"""PyTorch / CUDA port of the Monte Carlo stock-market simulator.

The JAX package ``stock_market_monte_carlo_tpu`` is the reference; this
package runs the same main path on an NVIDIA GPU with hand-written CUDA
kernels (``csrc/``), and on the CPU with their plain PyTorch versions
(``EngineOptions(device="cpu")``). It samples the JAX package's arithmetic
counter stream, so a run here reproduces a JAX run under
``SMMC_PRNG_IMPL=arith``. It imports neither jax nor the JAX package.

Ported so far: ``simulate_stats`` / ``simulate_final_values`` /
``simulate`` / ``run`` through the month loop under every model
(``HistoricalBootstrap`` on the counter or the reference-parity stream,
``GaussianReturns``, ``SobolGaussianReturns``, ``SobolHistoricalBootstrap``),
the CLT Gaussian sampler (``EngineOptions(gaussian_sampler="clt" |
"clt-prefix")``) or, with ``EngineOptions(terminal_law=True)``, the
terminal law, chosen as the JAX package chooses it, with seed segments
past ``seed_segment_paths``; ``simulate_bands`` (hist, cdf and analytic
modes); ``simulate_paths`` / ``run(keep_trajectories=...)``;
replicated-RQMC intervals (``rqmc_estimate``); checkpoints
(``simulate_stats(checkpoint_path=...)``); and paths meshes over
``torch.distributed`` (``parallel.paths_mesh``: every entry point but
``simulate_paths`` takes ``mesh=``).
"""

from stock_market_monte_carlo_torch.config import (
    EngineOptions,
    SimulationConfig,
)
from stock_market_monte_carlo_torch.models.market import (
    GaussianReturns,
    HistoricalBootstrap,
    MarketModel,
    SobolGaussianReturns,
    SobolHistoricalBootstrap,
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
    run,
    simulate,
    simulate_final_values,
    simulate_paths,
    simulate_stats,
)
from stock_market_monte_carlo_torch.engine.bands import (
    TrajectoryBands,
    simulate_bands,
)
from stock_market_monte_carlo_torch.engine.results import SimulationResult
from stock_market_monte_carlo_torch.engine.rqmc import (
    RqmcEstimate,
    rqmc_estimate,
)
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
    "SobolGaussianReturns",
    "SobolHistoricalBootstrap",
    "WithdrawalStrategy",
    "NoWithdrawal",
    "FixedAmountWithdrawal",
    "FixedPercentWithdrawal",
    "VariablePercentWithdrawal",
    "StreamUpdate",
    "simulate",
    "simulate_final_values",
    "simulate_stats",
    "simulate_paths",
    "run",
    "simulate_bands",
    "TrajectoryBands",
    "rqmc_estimate",
    "RqmcEstimate",
    "SimulationResult",
    "read_historical_returns",
    "default_returns_path",
]
