"""Walls of the main paths' ``simulate_stats`` calls at 100M paths x 360
months on one CUDA card, for comparing two checkouts of the port in turns:
run it from each checkout's root in one call (parent, change, change,
parent), with this file copied into the other checkout where it lacks it.

    python3 -m stock_market_monte_carlo_torch.bench.walls [NAME ...] \\
        [--reps N]

Each path is ``headline.time_row``: one warm-up call at the full shape,
then N calls (default 15), each timed with the host clock around the call
and a ``torch.cuda.synchronize()`` (seed 7, target 2000, the default 4096
histogram cells). NAME picks paths (default: all): ``law`` (the historical
terminal law, the headline's row), ``law_statsonly`` (no histogram),
``historical``, ``gaussian_icdf`` and ``clt``; ``clt_prefix`` (the CLT
prefix kernel, ``gaussian_sampler="clt-prefix"``) and
``gaussian_icdf_percent`` (the ICDF month loop) under
``FixedPercentWithdrawal(0.4)`` with the withdrawn total tracked, as
``chip_smoke.py`` phase 5 runs them; and ``simulate_bands`` as
``chip_smoke.py`` phase 5b runs it (3 levels, 32 sample paths, timed
alike): ``bands_hist`` (historical, 1024 bins) and ``bands_cdf``
(Gaussian, 32 thresholds). The XLA backend (``backend="xla"``):
``threefry_historical`` and ``threefry_gaussian`` (the threefry loop),
``threefry_sobol_gaussian`` (``SobolGaussianReturns.create(360)``, its
Sobol Gaussian draw on the run kernel) and ``law_threefry`` (the terminal
law's threefry draw, historical). Prints
the card's name and power limit, then
one JSON line {name: {"median_s", "rep_times_s"}}. Imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.bench import headline

N_PATHS = 100_000_000
N_PERIODS = 360
PERCENT = 0.4
PATHS = {
    # name: (model kind, options, percent withdrawn a month or None)
    "law": ("historical", dict(terminal_law=True), None),
    "law_statsonly": ("historical", dict(terminal_law=True,
                                         histogram=False), None),
    "historical": ("historical", {}, None),
    "gaussian_icdf": ("gaussian", {}, None),
    "clt": ("gaussian", dict(gaussian_sampler="clt"), None),
    "clt_prefix": ("gaussian", dict(gaussian_sampler="clt-prefix"),
                   PERCENT),
    "gaussian_icdf_percent": ("gaussian", {}, PERCENT),
    "threefry_historical": ("historical", dict(backend="xla"), None),
    "threefry_gaussian": ("gaussian", dict(backend="xla"), None),
    "threefry_sobol_gaussian": ("sobol_gaussian", dict(backend="xla"),
                                None),
    "law_threefry": ("historical", dict(backend="xla", terminal_law=True),
                     None),
}
BANDS = {
    "bands_hist": ("historical", dict(band_mode="hist", n_bins=1024)),
    "bands_cdf": ("gaussian", dict(band_mode="cdf", n_thresholds=32)),
}


def time_bands(model, kw, reps):
    """(median s, every rep's s) of ``simulate_bands`` after one warm-up
    call, the host clock around each call and a synchronize."""
    def call():
        smt.simulate_bands(model, N_PATHS, N_PERIODS,
                           quantile_levels=(0.05, 0.5, 0.95),
                           sample_paths=32, **kw)
    call()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times), times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(PATHS) - set(BANDS)
    if unknown:
        ap.error(f"unknown paths {sorted(unknown)}; known: "
                 f"{list(PATHS) + list(BANDS)}")
    headline._require_card()
    print(headline.card_line(), flush=True)
    models = {"historical": smt.HistoricalBootstrap.from_csv(),
              "gaussian": smt.GaussianReturns(),
              "sobol_gaussian": smt.SobolGaussianReturns.create(N_PERIODS)}
    out = {}
    for name, (kind, opts, percent) in PATHS.items():
        if args.names and name not in args.names:
            continue
        med, times, _ = headline.time_row(
            models[kind], smt.EngineOptions(**opts), N_PATHS, N_PERIODS,
            args.reps, strategy=None if percent is None
            else smt.FixedPercentWithdrawal(percent))
        out[name] = dict(median_s=med, rep_times_s=times)
    for name, (kind, kw) in BANDS.items():
        if args.names and name not in args.names:
            continue
        med, times = time_bands(models[kind], kw, args.reps)
        out[name] = dict(median_s=med, rep_times_s=times)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
