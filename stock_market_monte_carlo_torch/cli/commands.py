"""Subcommand implementations: the port's copy of
``stock_market_monte_carlo_tpu/cli/commands.py``. Output formats follow
the reference binaries' print conventions (e.g. benchmark_mc_gpu.cpp:
74-80's stats block), line for line the JAX CLI's.

Where the port differs: every simulation runs on ``--device``
(``EngineOptions(device=...)``), and a command refuses when that is a card
torch cannot find; the device mean and the vector add are torch ops on
that device; ``n_devices`` > 1 is a paths mesh over ``torch.distributed``
(``parallel.paths_mesh``), one process a rank under ``torchrun
--nproc-per-node N``, where only rank 0 prints.
"""

from __future__ import annotations

import datetime
import json
import os
import time

import numpy as np
import torch

from stock_market_monte_carlo_torch.config import EngineOptions

# the process group's timeout under n_devices > 1: a rank that dies fails
# the others' collectives after this long
MESH_TIMEOUT_S = 600


def _device(args) -> torch.device:
    """The command's device; refuses a card torch cannot find."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: torch finds no CUDA device; pass "
            "--device cpu to run on the CPU")
    return dev


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _options(args, **kw) -> EngineOptions:
    _device(args)
    return EngineOptions(device=args.device, **kw)


def _model_historical(csv=None):
    from stock_market_monte_carlo_torch.models.market import (
        HistoricalBootstrap,
    )

    return HistoricalBootstrap.from_csv(csv)


def _print_stats_block(res, target):
    print(f"n_simulations: {res.n_paths}")
    print(f"All {res.n_paths} simulation done in {res.elapsed_s:.3f} s!")
    print(f"mean: {res.mean:.2f} | std: {res.std:.2f}")
    if res.count_below is not None:
        pct = 100.0 * res.prob_below
        print(
            f"count_below {target:.1f}: {res.count_below} ({pct:.4f}%)"
        )


def _prints(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _run_benchmark(args, n_months, n_sims, target=1000.0, mesh=None,
                   keep_trajectories=0, histogram=True,
                   terminal_law=False):
    import stock_market_monte_carlo_torch as smt

    options = _options(args, histogram=histogram, terminal_law=terminal_law)
    model = _model_historical()
    res = smt.run(
        model, n_sims, n_months, initial_capital=1000.0, seed=0,
        target_amount=target, options=options, mesh=mesh,
        keep_trajectories=keep_trajectories,
    )
    if _prints(mesh):
        _print_stats_block(res, target)
    return res


def benchmark_mc_cpu(args):
    # v1 semantics: trajectories retained (capped like the reference GUIs
    # cap drawn curves) + full stats
    _run_benchmark(args, args.n_months, args.n_simulations,
                   keep_trajectories=min(args.n_simulations, 256))


def benchmark_mc_cpu_v2(args):
    _run_benchmark(args, args.n_months, args.n_simulations)


def _mesh(n_devices, args):
    """(mesh, whether this call opened the process group): None for one
    device; else the world's ``n_devices`` ranks under torchrun, NCCL on
    the cards or gloo on the CPU."""
    import torch.distributed as dist

    from stock_market_monte_carlo_torch.parallel import paths_mesh

    dev = _device(args)
    if n_devices < 1:
        raise SystemExit(f"n_devices must be >= 1, got {n_devices}")
    if n_devices == 1:
        return None, False
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise SystemExit(
            f"requested {n_devices} devices, only "
            f"{torch.cuda.device_count()} available")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n_devices:
        raise SystemExit(
            f"n_devices {n_devices} runs under torchrun --nproc-per-node "
            f"{n_devices}, one process a rank; this process's WORLD_SIZE is "
            f"{world}")
    opened = not dist.is_initialized()
    if opened:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        return paths_mesh(n_devices,
                          device=None if dev.type == "cuda" else "cpu"), \
            opened
    except ValueError as e:
        raise SystemExit(str(e))


def _on_mesh(args, fn):
    """``fn(mesh)`` over the mesh of ``args.n_devices``; closes a process
    group this call opened."""
    import torch.distributed as dist

    mesh, opened = _mesh(args.n_devices, args)
    try:
        return fn(mesh)
    finally:
        if opened:
            dist.destroy_process_group()


def benchmark_mc_gpu(args):
    _on_mesh(args, lambda mesh: _run_benchmark(
        args, args.n_months, args.n_simulations, mesh=mesh))


def benchmark_mc_reduceblock(args):
    # the fused on-device stats path is the default engine; this command
    # exists for argv parity with benchmark_mc_gpu_reduceBlock, including
    # its CLT count-below estimate print (the reference's only option —
    # benchmark_mc_gpu_reduceBlock.cpp:65-70,109-113 — shown here next to
    # the exact on-device count it couldn't compute)
    from stock_market_monte_carlo_torch.ops.normal import count_below_clt

    def body(mesh):
        # histogram=False = the reduceBlock contract exactly: mean/variance
        # only ever leave the device (README.md:75 "compute means on GPU to
        # further reduce data transfer")
        res = _run_benchmark(args, args.n_months, args.n_simulations,
                             mesh=mesh, histogram=False,
                             terminal_law=getattr(args, "terminal_law",
                                                  False))
        est = float(count_below_clt(1000.0, res.mean, res.std, res.n_paths))
        if _prints(mesh):
            print(f"count_below 1000.0 (CLT estimate, ref parity): "
                  f"{est:,.0f} ({100 * est / res.n_paths:.4f}%)")
        return res

    _on_mesh(args, body)


def benchmark_reduce_mean(args):
    """Host-vs-device mean cross-check (ref: benchmark_reduce_mean.cpp:
    29-43 prints mean_cpu vs mean_gpu as its de-facto correctness test)."""
    dev = _device(args)
    rng = np.random.default_rng(0)
    vec = rng.random(args.n, dtype=np.float32)

    t0 = time.perf_counter()
    mean_host = float(vec.mean(dtype=np.float64))
    t_host = time.perf_counter() - t0

    x = torch.from_numpy(vec).to(dev)
    float(torch.mean(x))  # warm
    t0 = time.perf_counter()
    mean_dev = float(torch.mean(x))
    t_dev = time.perf_counter() - t0

    print(f"mean_host: {mean_host:.6f} ({t_host*1e3:.1f} ms)")
    print(f"mean_device: {mean_dev:.6f} ({t_dev*1e3:.1f} ms) "
          f"[{_device_name(dev)}]")
    rel = abs(mean_host - mean_dev) / abs(mean_host)
    print(f"rel_diff: {rel:.2e}")
    if rel > 1e-5:
        raise SystemExit("host/device mean mismatch")


def benchmark_google(args):
    """Repeated benchmark with Google-Benchmark-style JSON output
    (ref: benchmark_mc_gpu_google.cpp + README.md:87-96)."""
    import stock_market_monte_carlo_torch as smt

    options = _options(args)
    model = _model_historical()
    # untimed warm-up: rep 0 would otherwise carry the kernels' first
    # build and load, poisoning the mean aggregate and the U-test samples
    # benchmark-compare consumes
    smt.simulate_stats(model, args.n_simulations, args.n_months, seed=999,
                       options=options)
    runs = []
    for rep in range(args.repetitions):
        res = smt.simulate_stats(
            model, args.n_simulations, args.n_months, seed=rep,
            options=options,
        )
        runs.append(res.elapsed_s)
        print(f"rep {rep}: {res.elapsed_s:.4f} s "
              f"({args.n_simulations / res.elapsed_s:,.0f} paths/s)")
    name = f"mc/{args.n_months}/{args.n_simulations}"
    # Google-Benchmark-shaped: one entry per repetition plus aggregates,
    # so bench/compare.py can run the Mann-Whitney U test on the samples
    # (the reference workflow: --benchmark_repetitions=10 + compare.py,
    # README.md:87-96).
    entries = [
        {
            "name": name, "run_type": "iteration", "repetition_index": i,
            "real_time": float(t), "time_unit": "s",
        }
        for i, t in enumerate(runs)
    ]
    # ddof=1: Google Benchmark's stddev aggregate is the SAMPLE std
    for agg, val in (("mean", np.mean(runs)), ("median", np.median(runs)),
                     ("stddev",
                      np.std(runs, ddof=1) if len(runs) > 1 else 0.0)):
        entries.append({
            "name": f"{name}_{agg}", "run_type": "aggregate",
            "aggregate_name": agg, "real_time": float(val),
            "time_unit": "s",
        })
    entries[-3]["paths_per_second"] = (
        args.n_simulations / float(np.mean(runs))
    )
    out = {"benchmarks": entries}
    text = json.dumps(out, indent=2)
    if args.benchmark_out:
        with open(args.benchmark_out, "w") as f:
            f.write(text)
        print(f"wrote {args.benchmark_out}")
    else:
        print(text)


def benchmark_compare(args):
    from stock_market_monte_carlo_torch.bench.compare import compare_files

    compare_files(args.baseline, args.contender, plot_path=args.plot)


def benchmark_plot(args):
    """Single-file metric plotter with the reference's option surface
    (ref: python/benchmark_compare.py:39-163 — -m/-t/-r/--logx/--logy)."""
    from stock_market_monte_carlo_torch.bench.compare import plot_metric

    plot_metric(
        args.file, metric=args.metric, transform=args.transform,
        relative_to=args.relative_to, logx=args.logx, logy=args.logy,
        xlabel=args.xlabel, ylabel=args.ylabel, title=args.title,
        output=args.output,
    )


def monte_carlo_simulated(args):
    """Gaussian CSV writer (ref: monte_carlo_simulated.cpp:5-55 — one CSV
    per simulation with Returns/Values rows)."""
    import stock_market_monte_carlo_torch as smt

    options = _options(args)
    model = smt.GaussianReturns(mean_pct=args.mean, std_pct=args.std)
    traj = smt.simulate_paths(
        model, args.n_simulations, args.n_months,
        initial_capital=args.initial_capital, seed=args.seed,
        options=options,
    )
    _write_sim_csvs(traj, "gaussian", args.out_dir)
    print("Done!")


def monte_carlo_historical(args):
    """Historical CSV writer (ref: monte_carlo_historical.cpp:5-51)."""
    import stock_market_monte_carlo_torch as smt

    options = _options(args)
    print(f"initial_capital: {args.initial_capital} | "
          f"n_months: {args.n_months} | "
          f"n_simulations: {args.n_simulations}")
    model = _model_historical(args.csv)
    traj = smt.simulate_paths(
        model, args.n_simulations, args.n_months,
        initial_capital=args.initial_capital, seed=args.seed,
        options=options,
    )
    _write_sim_csvs(traj, "historical", args.out_dir)
    print("Done!")


def _write_sim_csvs(traj, prefix, out_dir):
    from stock_market_monte_carlo_torch.utils.io import write_data_file

    for i in range(traj.shape[0]):
        values = traj[i]
        returns = (values[1:] / values[:-1] - 1.0) * 100.0
        write_data_file(
            f"{prefix}_{i:05d}.csv", returns, values, out_dir=out_dir,
            verbose=(i < 3 or i == traj.shape[0] - 1),
        )


def visualize(args):
    from stock_market_monte_carlo_torch.viz.live import live_visualize

    live_visualize(
        n_months=args.n_months,
        n_simulations=args.n_simulations,
        model_kind=args.model,
        target=args.target,
        seed=args.seed,
        n_curves=args.curves,
        save=args.save,
        overlay_normal=getattr(args, "overlay_normal", False),
        live=getattr(args, "live", True),
        interactive=(True if getattr(args, "interactive", False) else None),
        live_fan=getattr(args, "live_fan", None),
        fan_frames=getattr(args, "fan_frames", None),
        gui=getattr(args, "gui", False),
        options=_options(args),
    )


def visualize_bands(args):
    """Percentile bands over the horizon for any path count — the keepdata
    GUI fan (visualize_returns_cpu.cpp:372-382) at O(T) host transfer."""
    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.engine.progress import (
        TerminalProgress,
    )
    from stock_market_monte_carlo_torch.viz.plots import band_chart

    options = _options(args)
    if args.model == "historical":
        model = smt.HistoricalBootstrap.from_csv()
    else:
        model = smt.GaussianReturns()
    bands = smt.simulate_bands(
        model, args.n_simulations, args.n_months,
        seed=args.seed, sample_paths=args.curves,
        progress=TerminalProgress(),
        band_mode=getattr(args, "band_mode", "hist"), options=options,
    )
    for q, row in zip(bands.quantile_levels, bands.values):
        print(f"p{int(q * 100):02d} final: {row[-1]:,.2f}")
    band_chart(bands, target=args.target,
               save=args.save or "outputs/visualize_bands.png",
               title=f"{args.model} MC bands")


def visualize_rng(args):
    from stock_market_monte_carlo_torch.viz.plots import rng_histograms

    rng_histograms(save=args.save, device=_device(args))


def visualize_distribution(args):
    from stock_market_monte_carlo_torch.viz.plots import distribution_curves

    distribution_curves(mean=args.mean, std=args.std, save=args.save,
                        device=_device(args))


def get_data(args):
    from stock_market_monte_carlo_torch.data.fetch import fetch_sp500

    fetch_sp500(args.out)


def plot_returns(args):
    from stock_market_monte_carlo_torch.viz.plots import plot_returns_csv

    plot_returns_csv(args.csv_file, save=args.save)


def plot_many_returns(args):
    from stock_market_monte_carlo_torch.viz.plots import (
        plot_many_returns_dir,
    )

    plot_many_returns_dir(
        args.dir, max_n=args.max_n,
        inflation_percent=args.inflation_percent, save=args.save,
    )


def demo_vector_add(args):
    """Device hello-world (ref: examples/example_gpu.cpp + src/gpu.cu)."""
    dev = _device(args)
    a = torch.arange(args.n, dtype=torch.float32, device=dev)
    b = torch.ones((args.n,), dtype=torch.float32, device=dev)
    out = torch.add(a, b)
    ok = bool(torch.all(out[:16] == a[:16] + 1))
    print(f"vector_add on {_device_name(dev)}: "
          f"{'OK' if ok else 'MISMATCH'} (n={args.n})")


def demo_gui(args):
    """GUI-toolkit showcase (ref: examples/example_imgui.cpp — the stock
    ImGui/ImPlot demo window with a small custom panel)."""
    from stock_market_monte_carlo_torch.viz.demo import demo_gui as run_demo

    win = run_demo(options=_options(args))
    print(f"demo window: model={win.model_kind} months={int(win.slider.val)}"
          f" mean={win.result.mean:,.1f} (headless backends return"
          " immediately)")
