"""Where the time goes in one 100M x 360 ``simulate_stats`` call of each
main path of the PyTorch port, on one CUDA card.

    python3 chip_profile.py

For each path (historical month loop, terminal law, Gaussian ICDF month
loop, Gaussian CLT): one warm-up call, then ``torch.profiler`` (CPU and
CUDA activity) over one call that ends in ``torch.cuda.synchronize()``.
Prints, per path, the profiled wall, the summed time of the CUDA-device
rows of ``key_averages()`` (kernels and copies, each counted once), the
device busy share (device time over wall) and the rows that took most
device time. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
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
    paths = {
        "historical month loop": (hist, {}),
        "terminal law": (hist, dict(terminal_law=True)),
        "Gaussian ICDF month loop": (gauss, {}),
        "Gaussian CLT": (gauss, dict(gaussian_sampler="clt")),
    }
    for label, (model, opts) in paths.items():
        def run():
            return smt.simulate_stats(model, N_PATHS, N_PERIODS,
                                      target_amount=2000.0,
                                      options=smt.EngineOptions(**opts))

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
        top = sorted(rows, key=lambda r: -r.self_device_time_total)[:4]
        print(json.dumps({
            "path": label, "card": card, "wall_ms": wall_ms,
            "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
            "top": [dict(name=r.key[:60], count=r.count,
                         ms=r.self_device_time_total / 1e3) for r in top],
        }), flush=True)


if __name__ == "__main__":
    main()
