"""The port's headline benchmark, the counterpart of ``bench.py``:
``simulate_stats`` at 100M paths x 360 months on one card, through the
terminal law (the headline), the month loop and the CLT sampler, with the
kernels' device times, the dispatch floor and the calibrated integer
rate.

    python -m stock_market_monte_carlo_torch.bench.headline \\
        [n_paths] [n_periods] [--device cuda|cpu] [--mesh N]

Rows (``simulate_stats``, seed 7, ``target_amount=2000``, one warm-up at
the full run shape, then the median of the reps with every rep kept): the
historical terminal law with the 4096-cell histogram (the headline) and
stats only, the Gaussian terminal law, the historical terminal law at 1e9
paths (only at n_paths = 1e8), the historical month loop with the
histogram and stats only, the Gaussian ICDF month loop, the CLT sampler
with the histogram and stats only. Each row's mean is checked against the
analytic mean 1000 * g^T (g the float32 growth constant of the Gaussian
model, the mean of the float32 growth table of the historical one).

``device_times`` (a CUDA device only) gives per 2^24-path chunk the
kernels' times (CUDA events around back-to-back calls of the counted
wrappers), the dispatch tax of an isolated call, the dispatch floor (the
``const`` grid-overhead kernel) and its share of each kernel, the six law
chunks of a 100M run launched back to back, and the sustained int32
instruction rate from the calibration pair, with each kernel's predicted
time at that rate (``bench/roofline.py``) over its measured time.
``graph_ms`` times a launch with no host dispatch in it (launches
captured in one CUDA graph, its replays timed), for kernels so small that
back-to-back events time how fast the host dispatches.

Prints the full record on the line before the last, and on the last line
one JSON object of under 2000 characters: metric, value (law paths/s on
one card), unit, vs_baseline (over the RTX 3070's 1e8 paths in 0.13 s),
the device and a few device times. The default device is the card; with
no card it fails, it does not fall back to the CPU. ``--device cpu`` runs
the rows on the plain PyTorch versions and skips the device times.

``--mesh N`` runs every row over a paths mesh of N ranks (``parallel/
mesh.py``), as the JAX package's ``bench.py --mesh N`` does: start it
under ``torchrun --nproc-per-node N`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``); the
group runs NCCL on the cards, one a rank, and gloo with ``--device cpu``.
N must be the world size; on the cards it refuses before any launch when
the machine has fewer than N. Rank 0 prints the record and the last line,
with paths/s per chip (the wall's rate over N); the other ranks print
nothing, and the device times are skipped. ``--mesh 1`` is the
single-device run.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.bench import roofline
from stock_market_monte_carlo_torch.ops import calibration as cal
from stock_market_monte_carlo_torch.ops import cuda_engine as ce

# RTX 3070 reduceBlock: 100M x 360 historical, mean/var only (BASELINE.md)
BASELINE_PATHS_PER_S = 100_000_000 / 0.13
SEED = 7
WARM_SEED = 1
TARGET = 2000.0
V0 = 1000.0
CHUNK = 1 << 24
# back-to-back calls in one device-time measurement, and measurements
K = 6
REPS = 3
# a graph-replay measurement: launches a graph, replays, and the sleep
# before each replay (~0.5 ms at the H100's clock, far longer than the
# host takes to queue an event and a replay)
GRAPH_K = 20
GRAPH_REPS = 11
GRAPH_SLEEP_CYCLES = 1_000_000
GRID_SEED = 12345
CALIB_SEED = 123
# a row's mean against the analytic mean: this, or six standard errors
# where the sample is too small for it
MEAN_REL_BAR = 1e-3
LAST_LINE_MAX = 2000
FULL_RUN_PATHS = 100_000_000
BIG_RUN_PATHS = 1_000_000_000
# the process group's timeout under --mesh: a rank that dies fails the
# others' collectives after this long
MESH_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# Timing helpers.
# ---------------------------------------------------------------------------


def card_line():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def events_ms(call, k=K, reps=REPS):
    """Milliseconds per call on the card's clock: CUDA events around ``k``
    back-to-back calls ``call(0)`` .. ``call(k-1)``, after one warm-up
    call; the median of ``reps`` such measurements."""
    call(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(k):
            call(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


def graph_capture(make_launch, k=GRAPH_K):
    """``(graph, outputs)``: ``k`` calls of ``launch`` captured in one
    ``torch.cuda.CUDAGraph``, where ``make_launch()`` returns ``(launch,
    outputs)`` as the bare launchers do. One launch runs outside the
    capture first, so that lazy module loading does not happen inside it;
    the launch captured is built inside the capture, because a launcher
    reads the current stream when it is built and must read the capture
    stream."""
    launch, _ = make_launch()
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch, outputs = make_launch()
        for _ in range(k):
            launch()
    return graph, outputs


def graph_ms(make_launch, k=GRAPH_K, reps=GRAPH_REPS):
    """Milliseconds per launch with no host dispatch in them: CUDA events
    around one replay of ``graph_capture(make_launch, k)``, over ``k``; the
    median of ``reps`` replays, after one. A sleep kernel goes before each
    start event, so the host has queued the event and the replay before
    the card reaches them."""
    graph, _ = graph_capture(make_launch, k)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(GRAPH_SLEEP_CYCLES)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


def isolated_ms(call, reps=REPS):
    """Host-clock milliseconds of one call ending in
    ``torch.cuda.synchronize()``, the median of ``reps``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _require_card():
    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device; device times are "
                           "measured on the card only")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The rows.
# ---------------------------------------------------------------------------


def _rows(n_paths):
    """(name, model kind, EngineOptions keywords, reps, paths) per row."""
    rows = [
        ("historical_terminal_law", "historical", dict(terminal_law=True),
         9, n_paths),
        ("historical_terminal_law_statsonly", "historical",
         dict(terminal_law=True, histogram=False), 9, n_paths),
        ("gaussian_terminal_law", "gaussian", dict(terminal_law=True), 9,
         n_paths),
    ]
    if n_paths == FULL_RUN_PATHS:
        rows.append(("historical_terminal_law_1e9", "historical",
                     dict(terminal_law=True), 2, BIG_RUN_PATHS))
    return rows + [
        ("historical_month_loop", "historical", {}, 3, n_paths),
        ("historical_month_loop_statsonly", "historical",
         dict(histogram=False), 3, n_paths),
        ("gaussian_icdf", "gaussian", {}, 3, n_paths),
        ("gaussian_clt", "gaussian", dict(gaussian_sampler="clt"), 3,
         n_paths),
        ("gaussian_clt_statsonly", "gaussian",
         dict(gaussian_sampler="clt", histogram=False), 3, n_paths),
    ]


def analytic_means(models, n_periods):
    """{kind: 1000 * g^T}, g the float32 growth constant a of the Gaussian
    model, or the mean of the historical model's float32 growth table."""
    table, n = ce._pad_table(models["historical"].returns_pct)
    g_hist = float(np.mean(table[:n], dtype=np.float64))
    a = ce.gaussian_ab(models["gaussian"].mean_pct,
                       models["gaussian"].std_pct)[0]
    return {"historical": V0 * g_hist ** n_periods,
            "gaussian": V0 * a ** n_periods}


def time_row(model, options, n_paths, n_periods, reps, mesh=None,
             strategy=None):
    """(median s, every rep's s, the last result) of ``simulate_stats``
    (under ``strategy``, default none) after one warm-up call at the full
    run shape."""
    dev = torch.device(options.device)
    kw = dict(target_amount=TARGET, options=options, mesh=mesh)
    if strategy is not None:
        kw["strategy"] = strategy
    smt.simulate_stats(model, n_paths, n_periods, seed=WARM_SEED, **kw)
    times, res = [], None
    for _ in range(reps):
        _sync(dev)
        t = time.perf_counter()
        res = smt.simulate_stats(model, n_paths, n_periods, seed=SEED, **kw)
        _sync(dev)
        times.append(time.perf_counter() - t)
    return statistics.median(times), times, res


def run_rows(n_paths, n_periods, device, mesh=None):
    """{row name: its record} of every row on ``device`` (over ``mesh``;
    paths/s per chip)."""
    models = {"historical": smt.HistoricalBootstrap.from_csv(),
              "gaussian": smt.GaussianReturns()}
    analytic = analytic_means(models, n_periods)
    n_chips = 1 if mesh is None else mesh.size
    out = {}
    for name, kind, opts, reps, n in _rows(n_paths):
        options = smt.EngineOptions(device=device, **opts)
        med, times, res = time_row(models[kind], options, n, n_periods, reps,
                                   mesh)
        err = abs(res.mean / analytic[kind] - 1.0)
        sem = res.std / math.sqrt(n) / analytic[kind]
        bar = max(MEAN_REL_BAR, 6.0 * sem)
        out[name] = dict(
            n_paths=n, elapsed_s=med, rep_times_s=times,
            paths_per_sec=n / med / n_chips, mean=res.mean, std=res.std,
            analytic_mean=analytic[kind], mean_rel_err=err, mean_bar=bar,
            mean_ok=bool(math.isfinite(res.mean) and err <= bar))
    return out


# ---------------------------------------------------------------------------
# Device times.
# ---------------------------------------------------------------------------


def chunk_cases(n_periods, chunk=CHUNK, device="cuda"):
    """{case: (bound name, counted wrapper, ops, keywords, tile paths)} of
    one ``chunk``-path chunk of each timed kernel, with the operands
    ``simulate_stats`` builds for seed 7 and target 2000; the caller adds
    ``tile0``."""
    from stock_market_monte_carlo_torch.engine import engine as eng
    from stock_market_monte_carlo_torch.ops import clt
    from stock_market_monte_carlo_torch.ops import terminal_law as tlaw

    dev = torch.device(device)
    hist, gauss = smt.HistoricalBootstrap.from_csv(), smt.GaussianReturns()
    none = smt.NoWithdrawal()
    base = eng._segment_base(SEED, 0)
    bins = smt.EngineOptions().histogram_bins

    def common(model, with_hist):
        spec = eng.make_histogram_spec(model, none, n_periods, V0, bins)
        return dict(valid=chunk, n_paths=chunk, v0=V0, target=TARGET,
                    shift=eng.analytic_moment_shift(model, none, n_periods),
                    lo=spec.lo, log_lo=spec.log_lo, inv_w=1.0 / spec.width,
                    hb=spec.n_bins + 2, with_hist=with_hist,
                    keep_finals=False)

    law_host = tlaw.fit_terminal_law(hist, none, n_periods, V0).operand()
    law = (torch.as_tensor(law_host, device=dev),)
    law_kw = dict(seed_base=base ^ ce.LAW_STREAM_XOR,
                  inv_zmax=1.0 / tlaw.LAW_ZMAX, law_host=law_host)
    table, draw = ce.draw_operands(hist, dev)
    month = (table, torch.ones((n_periods,), dtype=torch.float32,
                               device=dev))
    month_kw = dict(strategy="none", amount=0.0, n_periods=n_periods,
                    seed_base=base, **draw)
    a, b = ce.gaussian_ab(gauss.mean_pct, gauss.std_pct)
    arow, cs = clt.block_consts(a, b, n_periods, None)
    clt_ops = (clt.q_tensor(dev), torch.as_tensor(arow, device=dev),
               torch.as_tensor(cs, device=dev), None)
    clt_kw = dict(variant="plain", seed_base=base ^ clt.CLT_STREAM_XOR)
    clt_tile = clt.tile_paths("plain")
    return {
        "law_hist": ("law", ce.law_chunk, law,
                     dict(common(hist, True), **law_kw), ce.TILE_PATHS),
        "law_statsonly": ("law", ce.law_chunk, law,
                          dict(common(hist, False), **law_kw),
                          ce.TILE_PATHS),
        "historical": ("month_loop", ce.month_loop_chunk, month,
                       dict(common(hist, True), **month_kw), ce.TILE_PATHS),
        "clt": ("clt", clt.clt_chunk, clt_ops,
                dict(common(gauss, True), **clt_kw), clt_tile),
        "clt_statsonly": ("clt", clt.clt_chunk, clt_ops,
                          dict(common(gauss, False), **clt_kw), clt_tile),
    }


def _law_run_ms(case, chunk, n_paths=FULL_RUN_PATHS, reps=REPS):
    """Device ms of the law chunks of an ``n_paths`` run launched back to
    back through the bare launchers (no epilogue between them), CUDA
    events around them, the median of ``reps``."""
    _, _, ops, kw, tile = case
    launches = [ce.law_launcher(*ops, **dict(
        kw, tile0=first // tile, valid=min(chunk, n_paths - first)))[0]
        for first in range(0, n_paths, chunk)]
    return events_ms(lambda i: [launch() for launch in launches], 1, reps)


def grid_overhead_report(chunk=CHUNK, k=K, reps=REPS):
    """``exp_grid_overhead.main`` on the card: per ``chunk``-path chunk, ms
    of the const and counter kernels at 1 and 16 tiles a block, alone (the
    bare launch) and through the counted wrapper; the fixed cost of a
    block from the const kernels; and whether the counter bits are
    identical across the grouping."""
    dev = _require_card()
    n_tiles = chunk // ce.TILE_PATHS
    kw = dict(seed=GRID_SEED, n_tiles=n_tiles, device=dev)
    out = {}
    for variant in cal.VARIANTS:
        for group in (1, 16):
            launch, _ = cal.grid_overhead_launcher(variant, group, **kw)
            out[f"{variant}{group}_kernel_ms"] = events_ms(
                lambda i, launch=launch: launch(), k, reps)
            out[f"{variant}{group}_ms_per_chunk"] = events_ms(
                lambda i, v=variant, g=group: cal.grid_overhead_chunk(
                    v, g, **kw), k, reps)
    delta = out["const1_kernel_ms"] - out["const16_kernel_ms"]
    out["fixed_us_per_block"] = delta * 1e3 / (n_tiles - n_tiles // 16)
    one, sixteen = (cal.grid_overhead_chunk("counter", g, **kw)
                    for g in (1, 16))
    out["counter_bits_identical_across_grouping"] = bool(
        torch.equal(one[0], sixteen[0]) and torch.equal(one[1], sixteen[1]))
    return out


def calib_report(n_periods=360, chunk=CHUNK, k=K, reps=REPS):
    """``exp_hist_roofline.run_calib`` on the card for n_ops 16 and 48: ms
    per ``chunk``-path chunk, the SASS instructions of a month of each
    kernel, and the sustained int32 instruction rate, paths x months x
    (instructions of the 32 extra operators) over the time between the
    two."""
    dev = _require_card()
    out = {}
    for n_ops in cal.CALIB_OPS:
        def call(i, n_ops=n_ops):
            return cal.calib_chunk(n_ops, n_periods=n_periods, n_paths=chunk,
                                   seed=CALIB_SEED, device=dev)
        out[f"calib{n_ops}_ms"] = events_ms(call, k, reps)
        out[f"calib{n_ops}_checksum"] = float(call(0).double().sum())
    instr = cal.calib_sass_instructions()
    lo, hi = cal.CALIB_OPS
    extra = instr[hi] - instr[lo]
    months = cal.calib_months(n_periods)
    dt = (out[f"calib{hi}_ms"] - out[f"calib{lo}_ms"]) / 1e3
    out.update(
        calib_months=months,
        calib_sass_instructions_per_month={str(n): v
                                           for n, v in instr.items()},
        int_op_rate_per_s=chunk * months * extra / dt,
    )
    out["int_op_rate_vs_assumed"] = (out["int_op_rate_per_s"]
                                     / roofline.SCALAR_OPS_PER_S)
    return out


def device_times(n_periods, chunk=CHUNK, k=K, reps=REPS):
    """The per-chunk device-time block on the card (see the module
    docstring)."""
    dev = _require_card()
    out = {"method": (
        f"CUDA events around {k} back-to-back counted wrapper calls on "
        f"{chunk}-path chunks after a warm-up, median of {reps}; dispatch "
        "tax: host clock around one call ending in torch.cuda.synchronize()"
        f", median of {reps}, minus the batched time")}
    n_tiles = chunk // ce.TILE_PATHS
    floor = events_ms(lambda i: cal.grid_overhead_chunk(
        "const", 16, seed=GRID_SEED, n_tiles=n_tiles, device=dev), k, reps)
    out["dispatch_floor_ms_per_chunk"] = floor
    cases = chunk_cases(n_periods, chunk, dev)
    for name, (_, wrapper, ops, kw, tile) in cases.items():
        def call(i, wrapper=wrapper, ops=ops, kw=kw, tile=tile):
            return wrapper(*ops, tile0=i * chunk // tile, **kw)
        ms = events_ms(call, k, reps)
        out[f"{name}_ms_per_chunk"] = ms
        out[f"{name}_dispatch_tax_ms"] = isolated_ms(lambda: call(0),
                                                     reps) - ms
        out[f"{name}_floor_fraction"] = floor / ms
    out["law_hist_100m_device_ms"] = _law_run_ms(cases["law_hist"], chunk,
                                                 reps=reps)
    out.update(calib_report(n_periods, chunk, k, reps))
    rate = out["int_op_rate_per_s"]
    for name, (bound_name, _, ops, kw, _) in cases.items():
        pred = roofline.bound(bound_name, ops, kw, scalar_rate=rate)[0]
        out[f"{name}_predicted_ms_per_chunk"] = pred
        out[f"{name}_roofline_fraction"] = pred / out[f"{name}_ms_per_chunk"]
    return out


# ---------------------------------------------------------------------------
# The entry point.
# ---------------------------------------------------------------------------


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="python -m stock_market_monte_carlo_torch.bench.headline",
        description="The port's headline benchmark (one JSON line last).")
    p.add_argument("n_paths", nargs="?", type=int, default=FULL_RUN_PATHS)
    p.add_argument("n_periods", nargs="?", type=int, default=360)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--mesh", type=int, default=None,
                   help="ranks of a paths mesh, under torchrun")
    args = p.parse_args(argv)
    return args.n_paths, args.n_periods, args.device, args.mesh


def open_mesh(n, device):
    """The paths mesh of ``--mesh n`` under torchrun: None for no mesh or
    one rank; else the world's n ranks over NCCL on the cards or gloo on
    the CPU. Refuses before any launch when the machine has fewer than n
    cards (on the cards) or the world is not n ranks."""
    import torch.distributed as dist

    from stock_market_monte_carlo_torch.parallel.mesh import paths_mesh

    if n is None or n == 1:
        return None
    if n < 1:
        raise ValueError(f"--mesh must be >= 1, got {n}")
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n:
            raise RuntimeError(
                f"--mesh {n} runs a rank on each of {n} cards; this machine "
                f"has {cards}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        raise ValueError(
            f"--mesh {n} runs under torchrun --nproc-per-node {n}, one "
            f"process a rank; this process's WORLD_SIZE is {world}")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo", init_method="env://",
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    return paths_mesh(n, device=None if device == "cuda" else "cpu")


def main(argv=None):
    """Run the headline; print the full record, then the compact line (on
    rank 0 of a mesh). Returns (record, compact)."""
    import torch.distributed as dist

    n_paths, n_periods, device, mesh_n = _parse(sys.argv[1:] if argv is None
                                                else argv)
    own_group = not dist.is_initialized()
    mesh = open_mesh(mesh_n, device)
    try:
        return _run(n_paths, n_periods, device, mesh)
    finally:
        if mesh is not None and own_group:
            dist.destroy_process_group()


def _run(n_paths, n_periods, device, mesh):
    on_card = device == "cuda"
    n_chips = 1 if mesh is None else mesh.size
    if on_card:
        dev = _require_card() if mesh is None else mesh.device
        kind, count = torch.cuda.get_device_name(dev), n_chips
        card = card_line()
    else:
        kind, count, card = "cpu", 0, None
    rows = run_rows(n_paths, n_periods, device, mesh)
    if mesh is not None:
        dt = {"skipped": f"device times are measured on one card; this run "
                         f"used a {n_chips}-rank mesh"}
    elif on_card:
        dt = device_times(n_periods)
    else:
        dt = {"skipped": "device times need a CUDA device; this run used "
                         "the CPU"}

    def rate(name):
        return rows[name]["paths_per_sec"]

    law_rate = rate("historical_terminal_law")
    gauss_best = max(rate("gaussian_icdf"), rate("gaussian_clt"))
    metric = f"paths_per_sec_per_chip_{n_periods}mo_historical_exact_law_hist"
    extra = {
        "n_paths": n_paths,
        "n_periods": n_periods,
        "sampler": "terminal_law (exact T-fold-convolution bootstrap law)",
        "statistic": "median of the reps; every rep in rep_times_s",
        "elapsed_s_historical_terminal_law":
            rows["historical_terminal_law"]["elapsed_s"],
        "elapsed_s_historical_terminal_law_statsonly":
            rows["historical_terminal_law_statsonly"]["elapsed_s"],
        "elapsed_s_gaussian_terminal_law":
            rows["gaussian_terminal_law"]["elapsed_s"],
        "terminal_law_mean": rows["historical_terminal_law"]["mean"],
    }
    if "historical_terminal_law_1e9" in rows:
        extra["elapsed_s_historical_terminal_law_1e9"] = rows[
            "historical_terminal_law_1e9"]["elapsed_s"]
        extra["terminal_law_1e9_paths_per_sec"] = rate(
            "historical_terminal_law_1e9")
    extra.update({
        "elapsed_s_historical_month_loop":
            rows["historical_month_loop"]["elapsed_s"],
        "vs_baseline_month_loop":
            rate("historical_month_loop") / BASELINE_PATHS_PER_S,
        "elapsed_s_historical_month_loop_statsonly":
            rows["historical_month_loop_statsonly"]["elapsed_s"],
        "vs_baseline_month_loop_statsonly":
            rate("historical_month_loop_statsonly") / BASELINE_PATHS_PER_S,
        "elapsed_s_gaussian_icdf": rows["gaussian_icdf"]["elapsed_s"],
        "elapsed_s_gaussian_clt": rows["gaussian_clt"]["elapsed_s"],
        "elapsed_s_gaussian_clt_statsonly":
            rows["gaussian_clt_statsonly"]["elapsed_s"],
        "gaussian_month_loop_paths_per_sec_per_chip": gauss_best,
        "vs_baseline_gaussian_month_loop_best":
            gauss_best / BASELINE_PATHS_PER_S,
        "n_chips": n_chips,
        "backend": device,
        "historical_mean": rows["historical_month_loop"]["mean"],
        "gaussian_mean": rows["gaussian_icdf"]["mean"],
        "gaussian_std": rows["gaussian_icdf"]["std"],
        "mean_rel_err_vs_analytic_icdf":
            rows["gaussian_icdf"]["mean_rel_err"],
        "mean_rel_err_vs_analytic_clt": rows["gaussian_clt"]["mean_rel_err"],
        "mean_rel_err_vs_analytic_terminal_law":
            rows["gaussian_terminal_law"]["mean_rel_err"],
        "means_ok": all(r["mean_ok"] for r in rows.values()),
        "rows": rows,
        "device_time": dt,
        "rep_times_s": [r["rep_times_s"] for r in rows.values()],
    })
    head = {"metric": metric, "value": law_rate, "unit": "paths/s/chip",
            "vs_baseline": law_rate / BASELINE_PATHS_PER_S}
    record = dict(head, extra=extra,
                  device={"platform": "gpu" if on_card else "cpu",
                          "kind": kind, "count": count},
                  card=card)
    compact = dict(head, device=kind, card=card, n_paths=n_paths,
                   n_periods=n_periods, means_ok=extra["means_ok"],
                   **{key: dt[key] for key in (
                       "law_hist_ms_per_chunk", "historical_ms_per_chunk",
                       "clt_ms_per_chunk", "law_hist_100m_device_ms",
                       "dispatch_floor_ms_per_chunk", "int_op_rate_per_s",
                       "historical_roofline_fraction",
                       "clt_roofline_fraction") if key in dt})
    line = json.dumps(compact)
    if len(line) >= LAST_LINE_MAX:
        raise RuntimeError(f"the last line has {len(line)} characters")
    if mesh is None or mesh.rank == 0:
        print(json.dumps(record))
        print(line, flush=True)
    return record, compact


if __name__ == "__main__":
    main()
