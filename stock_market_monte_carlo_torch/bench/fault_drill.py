"""Scale and fault drill: 1e10 paths in one call, and a run killed with
SIGKILL, resumed from its checkpoint and held to an uninterrupted one.

The port's counterpart of ``scripts/scale_fault_drill_tpu.py``:

1. **Scale.** The historical terminal law at 1e10 x 360 with its histogram
   (5 seed segments of 2^31 paths, ~597 chunks of 2^24, three deferred
   flushes): ``moments.n`` is 1e10 exactly, the histogram's masses sum to
   it and the mean lies within 1e-3 (plus 4 standard errors) of
   1000 g^360, g the table's mean growth factor. Then the historical month
   loop at 1e9 x 360. Wall, paths/s and peak device memory of each.
2. **Fault.** A child process runs a checkpointed 1e9 x 360 historical
   ``simulate_stats`` whose progress callback prints the paths done and
   then waits for a line on its standard input. After the third
   checkpointed chunk the parent sends SIGKILL: the callback is blocked,
   the checkpoint holds three chunks and the fourth chunk's kernel is in
   flight (the loop launches chunk k+1 before it fetches chunk k). The
   child must die of the signal; the parent resumes the run from the
   checkpoint and runs an uninterrupted control: the 9 packed stats and
   every histogram cell must be equal bit for bit.
3. **Checkpoint cost.** The 1e9 historical month loop and the 1e9 law,
   each with and without ``checkpoint_path``, 3 pairs in turns.

    python -m stock_market_monte_carlo_torch.bench.fault_drill \\
        [--quick] [--device cuda|cpu]

``--quick`` runs every part at a few 8192-path chunks of 12 months (the
law over 6 seed segments of 2^15 paths). One ``[fault_drill]`` JSON line a
part; exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

FULL = dict(law_n=10_000_000_000, loop_n=1_000_000_000,
            drill_n=1_000_000_000, months=360, chunk=1 << 24, seg=1 << 31)
QUICK = dict(law_n=5 * (1 << 15) + 777, loop_n=4 * 8192,
             drill_n=6 * 8192, months=12, chunk=8192, seg=1 << 15)
KILL_AFTER = 3          # checkpointed chunks before the SIGKILL
SEED, DRILL_SEED = 7, 11
TARGET = 2000.0
MEAN_REL = 1e-3         # the law's mean against 1000 g^T
PAIRS = 3               # checkpoint-cost pairs
V0 = 1000.0


def _options(device, sizes, **kw):
    import stock_market_monte_carlo_torch as smt

    return smt.EngineOptions(device=device, chunk_paths=sizes["chunk"],
                             seed_segment_paths=sizes["seg"], **kw)


def _sync(device):
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


@contextlib.contextmanager
def _one_cpu_thread(device):
    """On the CPU, torch on one thread while the drill's runs compare
    across processes: the plain version's bin log (MKL VML under ATen's
    parallel_for) was seen to round an edge value differently in about
    one fresh process in 60 under CPU load (ROADMAP queue 3, F5). The
    kernels on the card are not affected."""
    import torch

    n = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _timed(device, fn):
    """(result, wall s, peak device bytes or None) of one call; the peak
    counts what the call allocated above what the process held before
    it."""
    import torch

    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held if device != "cpu"
            else None)
    return out, wall, peak


def scale(device, sizes):
    """The 1e10 law and the 1e9 month loop: exact n and masses, the law's
    mean against 1000 g^T, wall, paths/s and peak memory."""
    import stock_market_monte_carlo_torch as smt

    hist = smt.HistoricalBootstrap.from_csv()
    t = sizes["months"]
    g = float((1.0 + np.asarray(hist.returns_pct, np.float64) / 100.0).mean())
    out, ok = {}, True
    for name, n, opts in (
            ("terminal_law", sizes["law_n"],
             _options(device, sizes, terminal_law=True)),
            ("month_loop", sizes["loop_n"], _options(device, sizes))):
        smt.simulate_stats(hist, sizes["chunk"], t, V0, 1, options=opts)
        res, wall, peak = _timed(device, lambda: smt.simulate_stats(
            hist, n, t, V0, SEED, target_amount=TARGET, options=opts))
        mean_rel = res.mean / (V0 * g**t) - 1.0
        se = res.std / (res.mean * np.sqrt(n))
        chunks = sum(-(-min(sizes["seg"], n - s) // sizes["chunk"])
                     for s in range(0, n, sizes["seg"]))
        rec = dict(n_paths=n, n_periods=t, wall_s=wall, paths_per_s=n / wall,
                   peak_bytes=peak, seed_segments=-(-n // sizes["seg"]),
                   chunks=chunks, mean=res.mean, std=res.std,
                   count_below=res.count_below, mean_rel_err=mean_rel,
                   mean_bar=MEAN_REL + 4.0 * se,
                   hist_mass=float(np.asarray(res.histogram_counts).sum()))
        rec["ok"] = bool(res.moments.n == n and rec["hist_mass"] == n
                         and abs(mean_rel) <= rec["mean_bar"])
        ok &= rec["ok"]
        out[name] = rec
    out["ok"] = ok
    return out


def _drill_args(sizes):
    import stock_market_monte_carlo_torch as smt

    return (smt.HistoricalBootstrap.from_csv(), sizes["drill_n"],
            sizes["months"], V0, DRILL_SEED)


def child(device, sizes, path):
    """The killed process: a checkpointed run whose progress callback
    reports each checkpointed chunk and waits for the parent's line."""
    import stock_market_monte_carlo_torch as smt

    def progress(done, total):
        print(f"CHECKPOINTED {done}", flush=True)
        if not sys.stdin.readline():      # the parent is gone
            os._exit(3)

    with _one_cpu_thread(device):
        smt.simulate_stats(*_drill_args(sizes), target_amount=TARGET,
                           options=_options(device, sizes),
                           checkpoint_path=path, progress=progress)
    print("FINISHED", flush=True)


def _final_update(updates):
    def stream(update):
        updates[:] = [update]
    return stream


def fault(device, sizes, quick):
    """SIGKILL a checkpointed run after its third chunk; resume it in this
    process; hold it to an uninterrupted control bit for bit."""
    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.engine import checkpoint as ckpt

    n, chunk = sizes["drill_n"], sizes["chunk"]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "drill.npz")
        cmd = [sys.executable, "-m",
               "stock_market_monte_carlo_torch.bench.fault_drill", "--child",
               path, "--device", device] + (["--quick"] if quick else [])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        with open(os.path.join(tmp, "child.err"), "w+") as err:
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE, stderr=err,
                                    text=True, cwd=repo, env=env)
            reported = []
            try:
                while len(reported) < KILL_AFTER:
                    line = proc.stdout.readline()
                    if not line.startswith("CHECKPOINTED"):
                        proc.wait(timeout=60)
                        err.seek(0)
                        raise RuntimeError(
                            f"drill child stopped early ({line!r}, status "
                            f"{proc.returncode}): {err.read()[-2000:]}")
                    reported.append(int(line.split()[1]))
                    if len(reported) < KILL_AFTER:
                        proc.stdin.write("\n")
                        proc.stdin.flush()
                # blocked in its progress callback, the next chunk queued
                os.kill(proc.pid, signal.SIGKILL)
                status = proc.wait(timeout=60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                proc.stdin.close()
                proc.stdout.close()
        child_s = time.perf_counter() - t0
        with np.load(path) as z:
            state = ckpt.load(path, bytes(z["fingerprint"]).decode())
        opts = _options(device, sizes)
        resumed_up, control_up = [], []
        with _one_cpu_thread(device):
            resumed, resume_s, _ = _timed(device, lambda: smt.simulate_stats(
                *_drill_args(sizes), target_amount=TARGET, options=opts,
                checkpoint_path=path, stream=_final_update(resumed_up)))
            control, control_s, _ = _timed(device, lambda: smt.simulate_stats(
                *_drill_args(sizes), target_amount=TARGET, options=opts,
                stream=_final_update(control_up)))
    stats_equal = bool(np.array_equal(
        resumed_up[0].stats.view(np.uint64),
        control_up[0].stats.view(np.uint64)))
    hist_equal = bool(np.array_equal(resumed.histogram_counts,
                                     control.histogram_counts))
    rec = dict(
        n_paths=n, n_periods=sizes["months"], chunks=-(-n // chunk),
        reported=reported, kill="SIGKILL", exit_status=status,
        checkpoint_paths_done=state.paths_done,
        checkpoint_next_offset=state.next_offset, child_wall_s=child_s,
        resume_wall_s=resume_s, control_wall_s=control_s,
        stats_bit_equal=stats_equal, hist_bit_equal=hist_equal,
        moments_equal=resumed.moments == control.moments,
        resumed_n=resumed.moments.n)
    rec["ok"] = bool(status == -signal.SIGKILL
                     and 0 < state.paths_done < n
                     and state.paths_done == KILL_AFTER * chunk
                     and stats_equal and hist_equal and rec["moments_equal"]
                     and resumed.moments.n == n)
    return rec


def checkpoint_cost(device, sizes, pairs=PAIRS):
    """Walls of the 1e9 month loop and the 1e9 law with and without a
    checkpoint, ``pairs`` pairs in turns (without first in even pairs)."""
    import stock_market_monte_carlo_torch as smt

    hist = smt.HistoricalBootstrap.from_csv()
    n, t = sizes["loop_n"], sizes["months"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, opts in (("month_loop", _options(device, sizes)),
                           ("terminal_law", _options(device, sizes,
                                                     terminal_law=True))):
            smt.simulate_stats(hist, sizes["chunk"], t, V0, 1, options=opts)
            walls = {"without": [], "with": []}
            for i in range(pairs):
                for arm in (("without", "with") if i % 2 == 0
                            else ("with", "without")):
                    path = os.path.join(tmp, f"{name}{i}.npz")
                    walls[arm].append(_timed(device, lambda: smt.simulate_stats(
                        hist, n, t, V0, SEED, target_amount=TARGET,
                        options=opts,
                        checkpoint_path=path if arm == "with" else None))[1])
                    if os.path.exists(path):
                        os.remove(path)
            med = {k: float(np.median(v)) for k, v in walls.items()}
            out[name] = dict(n_paths=n, n_periods=t,
                             saves=-(-n // sizes["chunk"]), walls_s=walls,
                             median_s=med,
                             ratio=med["with"] / med["without"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--child", metavar="CHECKPOINT",
                    help="run as the drill's child, checkpointing there")
    args = ap.parse_args(argv)
    sizes = QUICK if args.quick else FULL
    if args.child:
        child(args.device, sizes, args.child)
        return {}
    records = {}
    for part, fn in (("fault", lambda: fault(args.device, sizes,
                                             args.quick)),
                     ("scale", lambda: scale(args.device, sizes)),
                     ("checkpoint_cost", lambda: checkpoint_cost(
                         args.device, sizes))):
        records[part] = fn()
        print(f"[fault_drill] {part}: {json.dumps(records[part])}",
              flush=True)
    return records


if __name__ == "__main__":
    recs = main()
    sys.exit(0 if all(recs[k]["ok"] for k in ("fault", "scale")
                      if k in recs) else 1)
