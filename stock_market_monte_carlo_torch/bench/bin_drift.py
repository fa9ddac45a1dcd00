"""Does a CPU run bin its finals the same in every process, under load?

The plain version's histogram bin takes the log of each final on the CPU
(``cuda_engine._kernel_bin_indices``). This script runs the quick fault
drill's run (the historical month loop, 6 chunks of 8192 paths x 12
months, seed 11, target 2000, on the CPU) in ``--procs`` fresh processes
one after another, with torch at its default thread count, while
``--hogs`` other processes multiply 1024 x 1024 float32 matrices in a
loop; and once, first, on one thread with no load as the reference. Each
process prints its 9 packed sums and its histogram; a process differs
when either is not bit-equal to the reference's.

    python -m stock_market_monte_carlo_torch.bench.bin_drift \\
        [--procs 60] [--hogs 6]

Prints one ``[bin_drift]`` JSON line: processes, hogs, how many differed
(histogram, sums), and for each that did the paths whose cell moved.
Exit status 1 when any process differed. CPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_PATHS, MONTHS, CHUNK, SEED, TARGET = 6 * 8192, 12, 8192, 11, 2000.0
HOG = ("import torch\n"
       "a = torch.randn(1024, 1024)\n"
       "while True:\n"
       "    a = torch.tanh(a @ a)\n")


def child():
    """One run; prints the sums' bytes and the histogram as JSON."""
    import stock_market_monte_carlo_torch as smt

    updates = []
    res = smt.simulate_stats(
        smt.HistoricalBootstrap.from_csv(), N_PATHS, MONTHS, seed=SEED,
        target_amount=TARGET,
        options=smt.EngineOptions(device="cpu", chunk_paths=CHUNK),
        stream=updates.append)
    print(json.dumps({"stats": updates[-1].stats.tobytes().hex(),
                      "hist": res.histogram_counts.tolist()}))


def _run_child(repo, threads=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if threads is not None:
        env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = str(threads)
    out = subprocess.run(
        [sys.executable, "-m", "stock_market_monte_carlo_torch.bench."
         "bin_drift", "--child"], capture_output=True, text=True,
        timeout=300, check=True, cwd=repo, env=env)
    return json.loads(out.stdout.strip().splitlines()[-1])


def measure(procs, hogs):
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ref = _run_child(repo, threads=1)
    ref_hist = np.asarray(ref["hist"])
    hog_procs = [subprocess.Popen([sys.executable, "-c", HOG],
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
                 for _ in range(hogs)]
    moved, sums_differ = [], 0
    t0 = time.perf_counter()
    try:
        for _ in range(procs):
            got = _run_child(repo)
            diff = np.abs(np.asarray(got["hist"]) - ref_hist).sum()
            moved.append(int(diff // 2))
            sums_differ += got["stats"] != ref["stats"]
    finally:
        for p in hog_procs:
            p.kill()
        for p in hog_procs:
            p.wait()
    return dict(procs=procs, hogs=hogs, n_paths=N_PATHS, n_periods=MONTHS,
                chunk_paths=CHUNK, cores=os.cpu_count(),
                hist_differ=sum(m > 0 for m in moved),
                sums_differ=int(sums_differ),
                paths_moved=[m for m in moved if m],
                wall_s=time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=60)
    ap.add_argument("--hogs", type=int, default=6)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        child()
        return None
    rec = measure(args.procs, args.hogs)
    print(f"[bin_drift] {json.dumps(rec)}", flush=True)
    return rec


if __name__ == "__main__":
    rec = main()
    sys.exit(0 if rec is None or not (rec["hist_differ"]
                                      or rec["sums_differ"]) else 1)
