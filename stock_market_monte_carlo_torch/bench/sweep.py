"""Extended benchmark sweep: one JSON line per config, the port's
counterpart of the repository's ``bench_all.py`` (same configs, ``metric``
names and ``extra`` keys).

    python -m stock_market_monte_carlo_torch.bench.sweep [--quick]
        [--device cuda|cpu]

Configs:

1. ``gaussian_360mo_finals``: Gaussian finals, 1M x 360 (the ICDF loop);
2. ``historical_360mo_stats``: historical bootstrap stats, 1M x 360;
3. ``v1_trajectories_with_bands``: 65,536 trajectories (16,384 with
   ``--quick``) and their percentile bands on the host;
4. ``sobol_qmc_120mo``: Sobol against pseudo-random at 2^17 x 120 (the
   Sobol loop), mean errors against the analytic mean;
5. ``billion_path_fused_hist``: 1e9 Gaussian paths (1e8 with ``--quick``)
   on the CLT sampler;
6. ``trajectory_bands_device``: percentile bands of 1e7 paths (1e6) in
   hist mode (the band histogram);
7. ``trajectory_bands_cdf``: the same in cdf mode (the counts below
   thresholds), on every device: the port's cdf kernel runs where the JAX
   package's Pallas backend did;
8. ``terminal_law_gaussian`` and ``terminal_law_historical``: the terminal
   law at config 5's paths.

Each timed run follows an untimed one at its exact shape. ``--device``
(default ``cuda``) is ``EngineOptions.device``. Prints one JSON line a
config; ``main`` returns the records.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# bench_all.py's horizons and paths; a pair is (full, --quick)
MONTHS = 360
QMC_MONTHS = 120
PATHS = 1_000_000                 # configs 1 and 2
TRAJECTORIES = (65_536, 16_384)   # config 3
QMC_PATHS = 2**17                 # config 4
FUSED_PATHS = (10**9, 10**8)      # configs 5 and 8
BAND_PATHS = (10**7, 10**6)       # configs 6 and 7


def _line(records, name, paths, periods, seconds, extra=None):
    rec = {
        "metric": name,
        "value": round(paths / seconds, 1),
        "unit": "paths/s",
        "extra": {"n_paths": paths, "n_periods": periods,
                  "elapsed_s": round(seconds, 4), **(extra or {})},
    }
    records.append(rec)
    print(json.dumps(rec), flush=True)


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.config import EngineOptions

    args = _parse(sys.argv[1:] if argv is None else argv)
    quick = int(args.quick)
    t_mo = MONTHS
    n1 = PATHS
    opts = EngineOptions(device=args.device)
    records = []

    gauss = smt.GaussianReturns()
    hist = smt.HistoricalBootstrap.from_csv()

    # warm-ups with the exact shapes each config dispatches (configs 3, 4
    # and 6 warm inline just before their timed regions)
    smt.simulate_final_values(gauss, n1, t_mo, seed=1, options=opts)
    smt.simulate_stats(hist, n1, t_mo, seed=1, options=opts)

    # 1. Gaussian v2 final-only
    t0 = time.perf_counter()
    r = smt.simulate_final_values(gauss, n1, t_mo, seed=2, options=opts)
    _line(records, "gaussian_360mo_finals", n1, t_mo,
          time.perf_counter() - t0, {"mean": float(np.mean(r))})

    # 2. Historical bootstrap
    t0 = time.perf_counter()
    res = smt.simulate_stats(hist, n1, t_mo, seed=2, options=opts)
    _line(records, "historical_360mo_stats", n1, t_mo,
          time.perf_counter() - t0, {"mean": round(res.mean, 2)})

    # 3. v1 store-all-paths (trajectory bands), capped like the reference
    n3 = TRAJECTORIES[quick]
    smt.simulate_paths(hist, n3, t_mo, seed=1, options=opts)  # warm
    t0 = time.perf_counter()
    traj = smt.simulate_paths(hist, n3, t_mo, seed=3, options=opts)
    bands = np.percentile(traj, [5, 25, 50, 75, 95], axis=0)
    _line(records, "v1_trajectories_with_bands", n3, t_mo,
          time.perf_counter() - t0,
          {"band_shape": list(bands.shape),
           "median_final": round(float(bands[2, -1]), 1)})

    # 4. Sobol vs pseudo convergence (mean abs error vs analytic, same n)
    t_qmc = QMC_MONTHS
    n4 = QMC_PATHS
    analytic = 1000.0 * (1 + float(gauss.mean_pct) / 100.0) ** t_qmc
    sob = smt.SobolGaussianReturns.create(n_periods=t_qmc)
    smt.simulate_stats(sob, n4, t_qmc, seed=1, options=opts)  # warm
    smt.simulate_stats(gauss, n4, t_qmc, seed=1, options=opts)
    t0 = time.perf_counter()
    r_s = smt.simulate_stats(sob, n4, t_qmc, seed=4, options=opts)
    dt = time.perf_counter() - t0
    r_p = smt.simulate_stats(gauss, n4, t_qmc, seed=4, options=opts)
    err_s = abs(r_s.mean - analytic) / analytic
    err_p = abs(r_p.mean - analytic) / analytic
    _line(records, "sobol_qmc_120mo", n4, t_qmc, dt, {
        "qmc_mean_rel_err": float(f"{err_s:.2e}"),
        "pseudo_mean_rel_err": float(f"{err_p:.2e}"),
        "qmc_error_ratio": float(f"{err_s / max(err_p, 1e-12):.3f}"),
    })

    # 5. 1B paths fused reduction (reduceBlock scale): the CLT sampler
    n5 = FUSED_PATHS[quick]
    opts_clt = EngineOptions(gaussian_sampler="clt", device=args.device)
    smt.simulate_stats(gauss, n5, t_mo, seed=1, options=opts_clt)  # warm
    t0 = time.perf_counter()
    res = smt.simulate_stats(gauss, n5, t_mo, seed=5, options=opts_clt)
    _line(records, "billion_path_fused_hist", n5, t_mo,
          time.perf_counter() - t0,
          {"mean": round(res.mean, 2), "std": round(res.std, 2),
           "hist_mass": float(res.histogram_counts.sum()),
           "sampler": "clt"})

    # 6. device-side percentile bands at scale (O(T) host transfer)
    n6 = BAND_PATHS[quick]
    smt.simulate_bands(gauss, n6, t_mo, seed=1, options=opts)  # warm
    t0 = time.perf_counter()
    b = smt.simulate_bands(gauss, n6, t_mo, seed=6, options=opts)
    _line(records, "trajectory_bands_device", n6, t_mo,
          time.perf_counter() - t0,
          {"median_final": round(float(b.band(0.5)[-1]), 1),
           "host_transfer_bytes": int(b.month_hist.nbytes)})

    # 7. cdf band mode: config 6's bands from counts below 32 analytic
    # thresholds a month and a probit inversion
    smt.simulate_bands(gauss, n6, t_mo, seed=1, band_mode="cdf",
                       options=opts)  # warm
    t0 = time.perf_counter()
    c = smt.simulate_bands(gauss, n6, t_mo, seed=6, band_mode="cdf",
                           options=opts)
    _line(records, "trajectory_bands_cdf", n6, t_mo,
          time.perf_counter() - t0,
          {"median_final": round(float(c.band(0.5)[-1]), 1),
           "host_transfer_bytes": int(c.month_hist.nbytes)})

    # 8. the terminal-law sampler: V_T in one step from its exact T-fold
    # convolution law; not like-for-like with the month loops, so a config
    # of its own
    n8 = n5
    law = EngineOptions(terminal_law=True, device=args.device)
    for name, model in (("gaussian", gauss), ("historical", hist)):
        smt.simulate_stats(model, n8, t_mo, seed=1, options=law)  # warm
        t0 = time.perf_counter()
        res = smt.simulate_stats(model, n8, t_mo, seed=8, options=law)
        _line(records, f"terminal_law_{name}", n8, t_mo,
              time.perf_counter() - t0,
              {"mean": round(res.mean, 2), "std": round(res.std, 2),
               "hist_mass": float(res.histogram_counts.sum())})
    return records


if __name__ == "__main__":
    main()
