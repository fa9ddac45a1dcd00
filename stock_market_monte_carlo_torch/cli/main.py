"""CLI: one entry point mirroring every reference executable.

The port's copy of ``stock_market_monte_carlo_tpu/cli/main.py``: the same
19 subcommands, positional arguments and options, plus one top-level
option, ``--device`` (default ``cuda``): the device the simulations run
on (``EngineOptions(device=...)``). The reference ships 16 binaries under
examples/ (examples/CMakeLists.txt:6-77). Each maps to a subcommand here
with the same positional arguments, e.g. ``build/benchmark_mc_gpu 1 360
100000000`` becomes ``smmc-torch benchmark-mc-gpu 1 360 100000000`` (or
``python -m stock_market_monte_carlo_torch.cli benchmark-mc-gpu 1 360
100000000``). A command that runs on a device refuses with a clear error
when ``--device cuda`` finds no card; it never carries on on the CPU.
``n_devices`` > 1 runs under ``torchrun --nproc-per-node N``. GUI
visualizers map onto terminal/matplotlib surfaces (viz/), which need
matplotlib.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="smmc-torch",
        description="Monte Carlo stock-market simulator (PyTorch / CUDA)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device the simulations run on: cuda (the kernels, the "
             "default) or cpu (their plain PyTorch versions)")
    sub = parser.add_subparsers(dest="command", required=True)

    from stock_market_monte_carlo_torch.cli import commands as c

    # --- benchmarks (reference: examples/benchmark_mc_*.cpp) ---
    p = sub.add_parser(
        "benchmark-mc-cpu",
        help="v1 keepdata engine benchmark (ref: benchmark_mc_cpu)",
    )
    p.add_argument("n_months", type=int)
    p.add_argument("n_simulations", type=int)
    p.set_defaults(fn=c.benchmark_mc_cpu)

    p = sub.add_parser(
        "benchmark-mc-cpu-v2",
        help="v2 final-only engine benchmark (ref: benchmark_mc_cpu_v2)",
    )
    p.add_argument("n_months", type=int)
    p.add_argument("n_simulations", type=int)
    p.set_defaults(fn=c.benchmark_mc_cpu_v2)

    p = sub.add_parser(
        "benchmark-mc-gpu",
        help="fused accelerator benchmark (ref: benchmark_mc_gpu)",
    )
    p.add_argument("n_devices", type=int)
    p.add_argument("n_months", type=int)
    p.add_argument("n_simulations", type=int)
    p.set_defaults(fn=c.benchmark_mc_gpu)

    p = sub.add_parser(
        "benchmark-mc-reduceblock",
        help="on-device stats reduction benchmark "
             "(ref: benchmark_mc_gpu_reduceBlock)",
    )
    p.add_argument("n_devices", type=int)
    p.add_argument("n_months", type=int)
    p.add_argument("n_simulations", type=int)
    p.add_argument("--terminal-law", action="store_true",
                   help="draw V_T in one step from its exact T-fold "
                        "convolution law instead of looping months "
                        "(ops/terminal_law.py; same distribution)")
    p.set_defaults(fn=c.benchmark_mc_reduceblock)

    p = sub.add_parser(
        "benchmark-reduce-mean",
        help="host-vs-device mean cross-check (ref: benchmark_reduce_mean)",
    )
    p.add_argument("n", type=int)
    p.set_defaults(fn=c.benchmark_reduce_mean)

    p = sub.add_parser(
        "benchmark-google",
        help="repeated benchmark with JSON output "
             "(ref: benchmark_mc_gpu_google)",
    )
    p.add_argument("n_months", type=int)
    p.add_argument("n_simulations", type=int)
    p.add_argument("--repetitions", type=int, default=10)
    p.add_argument("--benchmark_out", "--benchmark-out", dest="benchmark_out",
                   type=str, default=None)
    p.set_defaults(fn=c.benchmark_google)

    p = sub.add_parser(
        "benchmark-compare",
        help="compare two benchmark JSON files "
             "(ref: python/benchmark_compare.py)",
    )
    p.add_argument("baseline")
    p.add_argument("contender")
    p.add_argument("--plot", type=str, default=None,
                   help="write comparison plot PNG here")
    p.set_defaults(fn=c.benchmark_compare)

    p = sub.add_parser(
        "benchmark-plot",
        help="plot one benchmark file's metric curves "
             "(ref: python/benchmark_compare.py options)",
    )
    p.add_argument("-f", dest="file", required=True,
                   help="benchmark JSON or CSV file")
    p.add_argument("-m", dest="metric", default="real_time",
                   help="metric to plot (real_time, cpu_time, "
                        "bytes_per_second, items_per_second, "
                        "paths_per_second, iterations)")
    p.add_argument("-t", dest="transform", default="",
                   choices=["", "inverse"],
                   help="transform applied to the metric")
    p.add_argument("-r", dest="relative_to", default=None,
                   help="plot metrics relative to this label")
    p.add_argument("--logx", action="store_true")
    p.add_argument("--logy", action="store_true")
    p.add_argument("--xlabel", type=str, default="input size")
    p.add_argument("--ylabel", type=str, default=None)
    p.add_argument("--title", type=str, default="")
    p.add_argument("--output", type=str, default=None,
                   help="save the plot here instead of showing it")
    p.set_defaults(fn=c.benchmark_plot)

    # --- CSV writers (ref: monte_carlo_simulated / monte_carlo_historical) -
    p = sub.add_parser(
        "monte-carlo-simulated",
        help="write gaussian_#####.csv files (ref: monte_carlo_simulated; "
             "same hard-coded config)",
    )
    p.add_argument("--n-simulations", type=int, default=1000)
    p.add_argument("--initial-capital", type=float, default=1000.0)
    p.add_argument("--n-months", type=int, default=360)
    p.add_argument("--mean", type=float, default=6.0 / 12)
    p.add_argument("--std", type=float, default=10.0 / 12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", type=str, default="./outputs/")
    p.set_defaults(fn=c.monte_carlo_simulated)

    p = sub.add_parser(
        "monte-carlo-historical",
        help="write historical_#####.csv files (ref: monte_carlo_historical "
             "<initial_capital> <n_months> <n_simulations>)",
    )
    p.add_argument("initial_capital", type=float)
    p.add_argument("n_months", type=int)
    p.add_argument("n_simulations", type=int)
    p.add_argument("--csv", type=str, default=None,
                   help="returns CSV (default: reference path or vendored)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", type=str, default="./outputs/")
    p.set_defaults(fn=c.monte_carlo_historical)

    # --- visualizers (ref: examples/visualize_*.cpp GUIs) ---
    p = sub.add_parser(
        "visualize",
        help="live progress + stats + fan chart "
             "(ref: visualize_returns_cpu[_v2]/gpu)",
    )
    p.add_argument("n_months", type=int)
    p.add_argument("n_simulations", type=int)
    p.add_argument("--target", type=float, default=1000.0)
    p.add_argument("--model", choices=["historical", "gaussian"],
                   default="historical")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", type=str, default=None,
                   help="write the fan/histogram chart to this PNG")
    p.add_argument("--curves", type=int, default=100,
                   help="trajectories to draw (ref draws <=100)")
    p.add_argument("--overlay-normal", action="store_true",
                   help="overlay the CLT normal fit on the histogram "
                        "(ref: visualize_returns_distribution_gpu_"
                        "reduceBlock, fixed)")
    p.add_argument("--live", action="store_true", default=True,
                   help="redraw exact partial stats + histogram while the "
                        "run streams (default; ref render loop: "
                        "visualize_returns_cpu.cpp:296-434)")
    p.add_argument("--no-live", dest="live", action="store_false")
    p.add_argument("--interactive", action="store_true",
                   help="after the run, re-query P(final < amount) for "
                        "typed targets (ref slider recompute: "
                        "visualize_returns_cpu.cpp:340-356)")
    p.add_argument("--live-fan", type=str, default=None, metavar="PNG",
                   help="render the graphical trajectory fan + exact "
                        "partial histogram to this PNG, refreshed WHILE "
                        "the run streams (ref during-run plot: "
                        "visualize_returns_cpu.cpp:372-404)")
    p.add_argument("--fan-frames", type=str, default=None, metavar="DIR",
                   help="with --live-fan: also write numbered frame PNGs "
                        "here (an animation of the run)")
    p.add_argument("--gui", action="store_true",
                   help="open the interactive WINDOW: live fan + exact "
                        "partial histogram redrawn during the run, with "
                        "a target-amount slider recomputing P(below) "
                        "from the retained histogram (ref ImGui apps: "
                        "visualize_returns_cpu.cpp:296-434, slider "
                        ":340-356); headless backends build the window "
                        "without blocking")
    p.set_defaults(fn=c.visualize)

    p = sub.add_parser(
        "visualize-bands",
        help="device-side percentile bands over the horizon for any path "
             "count (keepdata fan at O(T) transfer)",
    )
    p.add_argument("n_months", type=int)
    p.add_argument("n_simulations", type=int)
    p.add_argument("--model", choices=["historical", "gaussian"],
                   default="historical")
    p.add_argument("--target", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--curves", type=int, default=20)
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--band-mode", choices=["hist", "cdf", "analytic"],
                   default="hist",
                   help="cdf: counts below 32 analytic thresholds/month + "
                        "probit inversion (the counts-below kernel). "
                        "analytic: EXACT "
                        "infinite-path bands from the FFT marginal laws "
                        "— zero device time, n_simulations ignored")
    p.set_defaults(fn=c.visualize_bands)

    p = sub.add_parser(
        "visualize-rng",
        help="PRNG uniformity histograms (ref: visualize_rng)",
    )
    p.add_argument("--save", type=str, default=None)
    p.set_defaults(fn=c.visualize_rng)

    p = sub.add_parser(
        "visualize-distribution",
        help="normal pdf/cdf curves (ref: visualize_distribution)",
    )
    p.add_argument("--mean", type=float, default=0.0)
    p.add_argument("--std", type=float, default=1.0)
    p.add_argument("--save", type=str, default=None)
    p.set_defaults(fn=c.visualize_distribution)

    # --- data + plots (ref: python/get_data.py, python/plot_returns.py) ---
    p = sub.add_parser(
        "get-data",
        help="fetch S&P500 monthly returns via yfinance "
             "(ref: python/get_data.py get_data_SP500)",
    )
    p.add_argument("--out", type=str,
                   default="data/SP500_monthly_returns.csv")
    p.set_defaults(fn=c.get_data)

    p = sub.add_parser(
        "plot-returns",
        help="plot one simulation CSV (ref: plot_returns.py plot_returns)",
    )
    p.add_argument("--csv_file", required=True)
    p.add_argument("--save", type=str, default=None)
    p.set_defaults(fn=c.plot_returns)

    p = sub.add_parser(
        "plot-many-returns",
        help="fan + violin plots over outputs/ "
             "(ref: plot_returns.py plot_many_returns)",
    )
    p.add_argument("--dir", type=str, default="outputs/")
    p.add_argument("--max_n", type=int, default=1000)
    p.add_argument("--inflation_percent", type=float, default=0.0)
    p.add_argument("--save", type=str, default=None)
    p.set_defaults(fn=c.plot_many_returns)

    p = sub.add_parser(
        "demo-vector-add",
        help="hello-world device check (ref: example_gpu/vector_add)",
    )
    p.add_argument("--n", type=int, default=1_000_000)
    p.set_defaults(fn=c.demo_vector_add)

    p = sub.add_parser(
        "demo-gui",
        help="GUI-toolkit showcase window: every widget kind the "
             "interactive window uses, wired to a live mini-simulation "
             "(ref: examples/example_imgui.cpp stock demo)",
    )
    p.set_defaults(fn=c.demo_gui)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main() or 0)
