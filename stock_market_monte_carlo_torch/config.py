"""Configuration dataclasses for the PyTorch engine.

Same fields and validation as ``stock_market_monte_carlo_tpu.config``, plus
``EngineOptions.device``: the device whose chunk functions run the
simulation. On a CUDA device they launch the hand-written kernels of
``ops/cuda_engine.py``; on ``"cpu"`` they run the plain PyTorch versions of
those kernels. Nothing falls back from one to the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DEFAULT_INITIAL_CAPITAL = 1000.0
# Gaussian market defaults: 6%/yr mean, 10%/yr std, expressed monthly in
# percent (reference: examples/monte_carlo_simulated.cpp:11-13).
DEFAULT_GAUSSIAN_MEAN_PCT = 6.0 / 12
DEFAULT_GAUSSIAN_STD_PCT = 10.0 / 12


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Execution knobs.

    Paths run in tiles of 8192 (TILE_PATHS): a tile's random stream depends
    only on its global index, so results are invariant to chunking.

    The fields and their validation are the JAX package's, plus
    ``device``. Where the port differs:

    - ``backend``: ``"auto"`` and ``"pallas"`` run the kernels' counter
      stream; ``"xla"`` the JAX package's XLA backend (the threefry
      stream, ``engine.chunk_stats``), on the threefry kernels on the card
      and in plain PyTorch on the CPU. The JAX package's ``"auto"``
      follows ``jax.default_backend()`` (``"xla"`` off a TPU); the port's
      is always its kernels' stream. Where the chunks run is ``device``.
    - ``fuse_chunks``: no effect. It fused chunks into one TPU dispatch to
      save a per-dispatch floor; CUDA launches are already asynchronous and
      every chunk is queued before the first host sync anyway.
    - ``gaussian_sampler``: honoured as the JAX package's Pallas backend
      honours it (``engine._effective_sampler``): "clt" and "clt-prefix"
      run the CLT kernel (``ops/clt.py``) where the JAX package would, and
      the Gaussian ICDF month loop elsewhere. The CLT kernel has no
      finals-free variant (``SMMC_CLT_FINALSFREE``): it writes finals only
      when asked for them, which is the same thing.
    """

    backend: str = "auto"
    # Paths per chunk; large runs loop over chunks of this size.
    chunk_paths: int = 2**24
    # Interior log-spaced bins; + underflow + overflow = 4096 cells.
    histogram_bins: int = 4094
    # False skips the final-value histogram.
    histogram: bool = True
    # False reports total_withdrawn as 0.0 (required by terminal_law runs
    # with a withdrawal strategy: withdrawn totals are path-dependent).
    track_withdrawn: bool = True
    # Collect per-path final values (4 bytes/path on the host).
    keep_final_values: bool = False
    gaussian_sampler: str = "icdf"
    # Draw V_T in one step from its fitted terminal law
    # (ops/terminal_law.py) instead of looping the months.
    terminal_law: bool = False
    fuse_chunks: int = 64
    # Runs larger than this run as seed segments, each on its own
    # threefry-keyed stream.
    seed_segment_paths: int = 1 << 31
    # run(keep_trajectories=...) trajectories: "float32" or "bfloat16"
    # (rounded, returned as float32).
    trajectory_dtype: str = "float32"
    # Where the chunks run: "cuda" (the kernels) or "cpu" (plain versions).
    device: str = "cuda"

    def __post_init__(self):
        if self.chunk_paths % 8192 != 0:
            raise ValueError(
                "chunk_paths must be a multiple of 8192 (the RNG/path tile),"
                f" got {self.chunk_paths}"
            )
        if self.chunk_paths > 2**24:
            # per-chunk counts travel as float32 in the chunk contract;
            # every integer up to 2^24 is exact there
            raise ValueError(
                "chunk_paths must be <= 2**24 to keep per-chunk f32 path "
                f"counts exact, got {self.chunk_paths}"
            )
        if not (0 <= self.fuse_chunks <= 64
                and (self.fuse_chunks & (self.fuse_chunks - 1)) == 0):
            raise ValueError(
                "fuse_chunks must be a power of two <= 64 (0/1 disables),"
                f" got {self.fuse_chunks}"
            )
        if (self.seed_segment_paths <= 0
                or self.seed_segment_paths % 8192 != 0):
            raise ValueError(
                "seed_segment_paths must be a positive multiple of 8192, "
                f"got {self.seed_segment_paths}"
            )
        if self.gaussian_sampler not in ("icdf", "clt", "clt-prefix"):
            raise ValueError(
                "gaussian_sampler must be 'icdf', 'clt', or 'clt-prefix', "
                f"got {self.gaussian_sampler!r}"
            )
        if self.trajectory_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "trajectory_dtype must be 'float32' or 'bfloat16', "
                f"got {self.trajectory_dtype!r}"
            )
        if self.backend not in ("auto", "pallas", "xla"):
            raise ValueError(
                "backend must be 'auto', 'pallas' or 'xla', got "
                f"{self.backend!r}; set device='cpu' for the plain PyTorch "
                "versions"
            )
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be a cuda or cpu device, got {self.device!r}"
            )


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """One Monte Carlo experiment (the JAX package's SimulationConfig)."""

    n_paths: int
    n_periods: int
    initial_capital: float = DEFAULT_INITIAL_CAPITAL
    seed: int = 0
    target_amount: Optional[float] = None

    def __post_init__(self):
        if self.n_paths <= 0:
            raise ValueError(f"n_paths must be positive, got {self.n_paths}")
        if self.n_periods <= 0:
            raise ValueError(
                f"n_periods must be positive, got {self.n_periods}"
            )
