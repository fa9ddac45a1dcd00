"""Where the time goes in one 100M x 360 call of each main path of the
PyTorch port, on one CUDA card.

    python3 chip_profile.py [PATH ...]

For each path (``simulate_stats`` through the historical month loop, the
terminal law, the Gaussian ICDF month loop, the Gaussian CLT and the Sobol
Gaussian, Sobol historical and reference-parity historical month loops;
the CLT prefix and the ICDF month loop under ``FixedPercentWithdrawal(0.4)``
with the withdrawn total tracked; the XLA backend (``backend="xla"``: the
threefry loop's historical and Gaussian draws, the Sobol Gaussian draw on
the run loop and the terminal law's threefry draw);
``simulate_bands`` on the historical model in hist mode and on the
Gaussian model in cdf mode, 32 sample paths each): one warm-up call, then
``torch.profiler`` (CPU and CUDA activity) over one call that ends in
``torch.cuda.synchronize()``; then ``cProfile`` over one more call, for
the host functions that took most of its wall.
PATH picks paths by label (default: all; for example "terminal law").
Prints, per path, the profiled wall, the summed time of the CUDA-device
rows of ``key_averages()`` (kernels and copies, each counted once), the
device busy share (device time over wall), the rows that took most
device time and the port's host functions that took most cumulative time
under ``cProfile`` (which slows Python calls, so those times read high).
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

N_PATHS = 100_000_000
N_PERIODS = 360


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: torch finds no CUDA device")
    import stock_market_monte_carlo_torch as smt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    hist = smt.HistoricalBootstrap.from_csv()
    gauss = smt.GaussianReturns()
    sobol_gauss = smt.SobolGaussianReturns.create(N_PERIODS)
    sobol_hist = smt.SobolHistoricalBootstrap.create(hist.returns_pct,
                                                     N_PERIODS)
    reference = smt.HistoricalBootstrap(hist.returns_pct, rng="reference")

    def stats(model, strategy=smt.NoWithdrawal(), **opts):
        return lambda: smt.simulate_stats(model, N_PATHS, N_PERIODS,
                                          target_amount=2000.0,
                                          strategy=strategy,
                                          options=smt.EngineOptions(**opts))

    def bands(model, **kw):
        return lambda: smt.simulate_bands(model, N_PATHS, N_PERIODS,
                                          sample_paths=32, **kw)

    paths = {
        "historical month loop": stats(hist),
        "terminal law": stats(hist, terminal_law=True),
        "Gaussian ICDF month loop": stats(gauss),
        "Gaussian CLT": stats(gauss, gaussian_sampler="clt"),
        "Sobol Gaussian month loop": stats(sobol_gauss),
        "Sobol historical month loop": stats(sobol_hist),
        "reference-parity month loop": stats(reference),
        "Gaussian CLT prefix, 0.4 % a month": stats(
            gauss, smt.FixedPercentWithdrawal(0.4),
            gaussian_sampler="clt-prefix"),
        "Gaussian ICDF month loop, 0.4 % a month": stats(
            gauss, smt.FixedPercentWithdrawal(0.4)),
        "XLA historical (threefry loop)": stats(hist, backend="xla"),
        "XLA Gaussian (threefry loop)": stats(gauss, backend="xla"),
        "XLA Sobol Gaussian (run loop)": stats(sobol_gauss, backend="xla"),
        "XLA terminal law (threefry)": stats(hist, backend="xla",
                                             terminal_law=True),
        "historical bands (hist)": bands(hist, band_mode="hist"),
        "Gaussian bands (cdf)": bands(gauss, band_mode="cdf"),
    }
    picked = sys.argv[1:]
    for label, run in paths.items():
        if picked and label not in picked:
            continue
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        rows = [r for r in prof.key_averages()
                if r.device_type == DeviceType.CUDA]
        dev_ms = sum(r.self_device_time_total for r in rows) / 1e3
        top = sorted(rows, key=lambda r: -r.self_device_time_total)[:6]
        host = cProfile.Profile()
        host.runcall(run)
        torch.cuda.synchronize()
        funcs = [(f"{fn[0].rsplit('/', 1)[-1]}:{fn[2]}", st[3])
                 for fn, st in pstats.Stats(host).stats.items()
                 if "stock_market_monte_carlo_torch" in fn[0]]
        print(json.dumps({
            "path": label, "card": card, "wall_ms": wall_ms,
            "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
            "top": [dict(name=r.key[:60], count=r.count,
                         ms=r.self_device_time_total / 1e3) for r in top],
            "host_cumulative_ms": [
                dict(name=name, ms=t * 1e3)
                for name, t in sorted(funcs, key=lambda x: -x[1])[:8]],
        }), flush=True)


if __name__ == "__main__":
    main()
