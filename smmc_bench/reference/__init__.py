"""The plain reference: what one query of a cell returns, from the seed,
the configuration and the table alone, in plain PyTorch and numpy.

It imports neither jax nor the JAX package nor anything of the port, and
takes nothing the port computed: the stream, the draws, the compounding,
the histogram's range, the bands' grids, the statistics and the
inversion are worked out here again.
"""

from __future__ import annotations

import torch

from smmc_bench.reference import analytics, inversion
from smmc_bench.reference.paths import Run


def query(config: dict, traffic: dict, table, seed: int, device,
          dtype=torch.float32) -> dict:
    """The reference's answer to one query: for ``simulate_stats`` the
    statistics and the histogram (``Run.stats``); for ``simulate_bands``
    the per-month counts and the band values."""
    run = Run(config, traffic, table, seed, device, dtype)
    if traffic["check"] == "stats":
        return run.stats()
    counts = run.month_counts()
    centers, scales = analytics.band_grid(run.model, run.table_np,
                                          run.strategy, run.n_periods,
                                          run.v0)
    call = traffic["call"]
    logthr = None
    if call["band_mode"] == "cdf":
        logthr = analytics.cdf_coefficients(
            centers, scales, int(call["n_thresholds"]), run.v0)[4]
    values = inversion.band_values(
        call["band_mode"], counts, tuple(call["quantile_levels"]), centers,
        scales, logthr, run.n_paths, run.v0)
    return dict(counts=counts, values=values)
