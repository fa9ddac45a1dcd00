"""The port's CLI (``python -m stock_market_monte_carlo_torch.cli``) on the
CPU, modelled on tests/test_cli.py: each of the 19 subcommands runs
through ``main([...])`` with ``--device cpu``.

- The stats a command prints come from a run equal to a direct port
  ``run(...)`` with the command's arguments bit for bit (moments,
  histogram, trajectories; tests/test_torch_engine.py holds that run to
  the JAX package under the arithmetic stream).
- The printed lines have the labels and order of the JAX CLI's output for
  the same command. The JAX CLI runs on its XLA backend with another
  stream, so its numbers are compared for shape only (every number masked).
- Without ``--device cpu`` and without a card, a command refuses.
"""

import builtins
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.cli.main import main as port_main
from stock_market_monte_carlo_torch.utils.io import read_data_file
from stock_market_monte_carlo_tpu.cli.main import main as jax_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = smt.EngineOptions(device="cpu")
_NUMBER = re.compile(r"-?\d[\d,]*(\.\d+)?(e[-+]?\d+)?|-?inf|nan")

SUBCOMMANDS = (
    "benchmark-mc-cpu", "benchmark-mc-cpu-v2", "benchmark-mc-gpu",
    "benchmark-mc-reduceblock", "benchmark-reduce-mean", "benchmark-google",
    "benchmark-compare", "benchmark-plot", "monte-carlo-simulated",
    "monte-carlo-historical", "visualize", "visualize-bands",
    "visualize-rng", "visualize-distribution", "get-data", "plot-returns",
    "plot-many-returns", "demo-vector-add", "demo-gui")


def _shape(text):
    return [_NUMBER.sub("#", ln) for ln in text.strip().splitlines()]


def _port(argv, capsys):
    port_main(["--device", "cpu", *argv])
    return capsys.readouterr().out


def _jax(argv, capsys):
    jax_main(list(argv))
    return capsys.readouterr().out


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def runs(monkeypatch):
    """The results of every ``smt.run`` / ``simulate_stats`` /
    ``simulate_paths`` / ``simulate_bands`` the command makes."""
    out = []
    for name in ("run", "simulate_stats", "simulate_paths",
                 "simulate_bands"):
        real = getattr(smt, name)

        def wrapped(*a, _real=real, _name=name, **k):
            res = _real(*a, **k)
            out.append((_name, a, k, res))
            return res

        monkeypatch.setattr(smt, name, wrapped)
    return out


def _subcommands(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    text = capsys.readouterr().out
    return tuple(re.search(r"\{([a-z0-9,-]+)\}", text).group(1).split(","))


def test_help_lists_the_jax_cli_s_subcommands(capsys):
    port = _subcommands(port_main, capsys)
    assert port == _subcommands(jax_main, capsys) == SUBCOMMANDS
    with pytest.raises(SystemExit):
        port_main(["--help"])
    assert "--device" in capsys.readouterr().out


# (argv, months, engine options); the historical terminal law needs 12
# months to fit (a shorter bootstrap law is a step function)
STATS = {
    "benchmark-mc-cpu": (["benchmark-mc-cpu", "3", "8192"], 3,
                         dict(keep=256)),
    "benchmark-mc-cpu-v2": (["benchmark-mc-cpu-v2", "6", "8192"], 6, {}),
    "benchmark-mc-gpu": (["benchmark-mc-gpu", "1", "6", "8192"], 6, {}),
    "benchmark-mc-reduceblock": (
        ["benchmark-mc-reduceblock", "1", "6", "8192"], 6,
        dict(histogram=False)),
    "benchmark-mc-reduceblock-law": (
        ["benchmark-mc-reduceblock", "1", "12", "8192", "--terminal-law"],
        12, dict(histogram=False, terminal_law=True)),
}


@pytest.mark.parametrize("case", sorted(STATS))
def test_stats_commands_equal_a_direct_run(case, in_tmp, runs, capsys):
    argv, months, kw = STATS[case]
    out = _port(argv, capsys)
    kw = dict(kw)
    keep = kw.pop("keep", 0)
    direct = smt.run(smt.HistoricalBootstrap.from_csv(), 8192, months,
                     initial_capital=1000.0, seed=0, target_amount=1000.0,
                     options=smt.EngineOptions(device="cpu", **kw),
                     keep_trajectories=keep)
    (name, _, _, res), = [r for r in runs if r[0] == "run"][:1]
    assert res.moments == direct.moments
    for field in ("histogram_counts", "trajectories"):
        a, b = getattr(res, field), getattr(direct, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b)
    lines = out.strip().splitlines()
    assert lines[0] == "n_simulations: 8192"
    assert lines[2] == f"mean: {direct.mean:.2f} | std: {direct.std:.2f}"
    pct = 100.0 * direct.prob_below
    assert lines[3] == (f"count_below 1000.0: {direct.count_below} "
                        f"({pct:.4f}%)")
    if case.startswith("benchmark-mc-reduceblock"):
        from stock_market_monte_carlo_torch.ops.normal import count_below_clt

        est = float(count_below_clt(1000.0, direct.mean, direct.std, 8192))
        assert lines[4] == (f"count_below 1000.0 (CLT estimate, ref "
                            f"parity): {est:,.0f} ({100 * est / 8192:.4f}%)")
    assert _shape(out) == _shape(_jax(argv, capsys))


@pytest.mark.parametrize("argv", [
    ["benchmark-reduce-mean", "100000"],
    ["demo-vector-add", "--n", "1024"],
])
def test_device_ops_print_as_jax_does(argv, capsys):
    out = _port(argv, capsys)
    assert _shape(out) == _shape(_jax(argv, capsys))
    if argv[0] == "demo-vector-add":
        assert out.strip() == "vector_add on cpu: OK (n=1024)"
    else:
        assert out.strip().splitlines()[1].endswith("[cpu]")
        assert float(out.split("rel_diff:")[1].split()[0]) < 1e-5


@pytest.mark.parametrize("kind", ["historical", "simulated"])
def test_csv_writers_write_the_run_s_trajectories(kind, in_tmp, runs,
                                                   capsys):
    if kind == "historical":
        argv = ["monte-carlo-historical", "1000", "3", "3"]
        model, v0, prefix = smt.HistoricalBootstrap.from_csv(), 1000.0, \
            "historical"
    else:
        argv = ["monte-carlo-simulated", "--n-simulations", "3",
                "--n-months", "3", "--initial-capital", "500"]
        model, v0, prefix = smt.GaussianReturns(6.0 / 12, 10.0 / 12), \
            500.0, "gaussian"
    out = _port(argv, capsys)
    direct = smt.simulate_paths(model, 3, 3, initial_capital=v0, seed=0,
                                options=CPU)
    files = sorted(os.listdir(in_tmp / "outputs"))
    assert files == [f"{prefix}_{i:05d}.csv" for i in range(3)]
    for i, f in enumerate(files):
        returns, values = read_data_file(str(in_tmp / "outputs" / f))
        # the CSV's six significant digits
        np.testing.assert_allclose(values, direct[i], rtol=5e-6)
        assert returns.shape == (3,)
    np.testing.assert_array_equal(runs[0][3], direct)
    assert out.strip().endswith("Done!")
    assert _shape(out) == _shape(_jax(argv, capsys))
    assert sorted(os.listdir(in_tmp / "outputs")) == files


def test_plot_commands_over_the_csvs(in_tmp, capsys):
    _port(["monte-carlo-historical", "1000", "3", "4"], capsys)
    out = _port(["plot-many-returns", "--dir", "outputs/"], capsys)
    assert (in_tmp / "outputs" / "MC_capital_overview.png").exists()
    assert (in_tmp / "outputs" / "MC_returns_overview.png").exists()
    # both packages read the same files with numpy: the same text
    assert out == _jax(["plot-many-returns", "--dir", "outputs/"], capsys)
    out = _port(["plot-returns", "--csv_file",
                 "outputs/historical_00000.csv"], capsys)
    assert (in_tmp / "outputs" / "values.png").exists()
    assert (in_tmp / "outputs" / "monthly_returns.png").exists()
    assert out == _jax(["plot-returns", "--csv_file",
                        "outputs/historical_00000.csv"], capsys)


def test_benchmark_google_compare_and_plot(in_tmp, runs, capsys):
    argv = ["benchmark-google", "12", "8192", "--repetitions", "3",
            "--benchmark-out", "a.json"]
    out = _port(argv, capsys)
    data = json.loads((in_tmp / "a.json").read_text())
    iters = [b for b in data["benchmarks"]
             if b.get("run_type") == "iteration"]
    assert [b["real_time"] for b in iters] == [
        r[3].elapsed_s for r in runs[1:]]
    assert [r[2]["seed"] for r in runs] == [999, 0, 1, 2]
    assert all(r[2]["options"].device == "cpu" for r in runs)
    jax_argv = [a.replace("--benchmark-out", "--benchmark_out")
                .replace("a.json", "j.json") for a in argv]
    assert _shape(out.replace("a.json", "x")) == _shape(
        _jax(jax_argv, capsys).replace("j.json", "x"))
    jax_data = json.loads((in_tmp / "j.json").read_text())
    assert [(b["name"], b["run_type"]) for b in data["benchmarks"]] == [
        (b["name"], b["run_type"]) for b in jax_data["benchmarks"]]
    out = _port(["benchmark-compare", "a.json", "a.json"], capsys)
    assert "1.00x" in out and "*" not in out.splitlines()[1]
    assert _shape(out) == _shape(_jax(["benchmark-compare", "a.json",
                                       "a.json"], capsys))
    out = _port(["benchmark-plot", "-f", "a.json", "--output", "p.png"],
                capsys)
    assert out.strip() == "saved p.png" and (in_tmp / "p.png").exists()


def test_visualize_prints_the_run_s_summary(in_tmp, runs, capsys):
    out = _port(["visualize", "3", "8192", "--curves", "5", "--save",
                 "viz.png", "--no-live", "--overlay-normal"], capsys)
    direct = smt.run(smt.HistoricalBootstrap.from_csv(), 8192, 3,
                     initial_capital=1000.0, seed=0, target_amount=1000.0,
                     options=CPU, keep_trajectories=5)
    res = [r for r in runs if r[0] == "run"][0][3]
    assert res.moments == direct.moments
    np.testing.assert_array_equal(res.trajectories, direct.trajectories)
    summary = [ln for ln in direct.summary().splitlines()
               if "simulations done" not in ln]
    got = [ln for ln in out.strip().splitlines()
           if "simulations done" not in ln]
    assert got == summary + ["saved viz.png"]
    assert (in_tmp / "viz.png").exists()


def test_visualize_bands_prints_the_bands(in_tmp, runs, capsys):
    argv = ["visualize-bands", "3", "8192", "--curves", "3", "--save",
            "b.png", "--band-mode", "cdf"]
    out = _port(argv, capsys)
    direct = smt.simulate_bands(smt.HistoricalBootstrap.from_csv(), 8192,
                                3, seed=0, sample_paths=3,
                                band_mode="cdf", options=CPU)
    want = [f"p{int(q * 100):02d} final: {row[-1]:,.2f}"
            for q, row in zip(direct.quantile_levels, direct.values)]
    assert out.strip().splitlines() == want + ["saved b.png"]
    assert (in_tmp / "b.png").exists()


@pytest.mark.parametrize("argv", [["visualize-rng", "--save", "r.png"],
                                  ["visualize-distribution", "--save",
                                   "d.png", "--mean", "1", "--std", "2"]])
def test_curve_commands_save(argv, in_tmp, capsys):
    out = _port(argv, capsys)
    assert out.strip() == f"saved {argv[2]}"
    assert (in_tmp / argv[2]).stat().st_size > 0


def test_demo_gui_runs_the_demo_s_stats(runs, capsys):
    out = _port(["demo-gui"], capsys)
    res = [r for r in runs if r[0] == "simulate_stats"][0][3]
    direct = smt.simulate_stats(smt.GaussianReturns(), 8192, 60, seed=0,
                                options=CPU)
    assert res.moments == direct.moments
    assert out.strip() == (
        f"demo window: model=gaussian months=60 mean={direct.mean:,.1f} "
        "(headless backends return immediately)")


def test_get_data_refuses_without_yfinance(in_tmp, monkeypatch):
    real = builtins.__import__

    def no_yf(name, *a, **k):
        if name == "yfinance":
            raise ImportError("no yfinance")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_yf)
    with pytest.raises(SystemExit, match="yfinance"):
        port_main(["get-data"])
    assert not (in_tmp / "data").exists()


DEVICE_COMMANDS = (
    ["benchmark-mc-cpu", "12", "8192"],
    ["benchmark-mc-cpu-v2", "12", "8192"],
    ["benchmark-mc-gpu", "1", "12", "8192"],
    ["benchmark-mc-reduceblock", "1", "12", "8192", "--terminal-law"],
    ["benchmark-reduce-mean", "1000"],
    ["benchmark-google", "12", "8192"],
    ["monte-carlo-simulated"],
    ["monte-carlo-historical", "1000", "12", "2"],
    ["visualize", "12", "8192"],
    ["visualize-bands", "12", "8192"],
    ["visualize-rng"],
    ["visualize-distribution"],
    ["demo-vector-add"],
    ["demo-gui"],
)


@pytest.mark.parametrize("argv", DEVICE_COMMANDS, ids=lambda a: a[0])
def test_without_a_card_a_command_refuses(argv, in_tmp, monkeypatch, runs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(argv)
    assert runs == []
    assert os.listdir(in_tmp) == []


@pytest.mark.parametrize("n", ["0", "2"])
def test_n_devices_outside_torchrun_refuses(n, monkeypatch, runs):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="WORLD_SIZE is 1" if n == "2"
                       else "n_devices must be >= 1"):
        port_main(["--device", "cpu", "benchmark-mc-gpu", n, "12", "8192"])
    assert runs == []


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_n_devices_under_torchrun_env(capsys):
    """``benchmark-mc-gpu 2 12 16384`` in two processes with torchrun's
    environment: a 2-rank gloo mesh, rank 0 prints the stats of the
    single-device run at the same chunk size, rank 1 prints nothing."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "stock_market_monte_carlo_torch.cli",
             "--device", "cpu", "benchmark-mc-gpu", "2", "12", "16384"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    (out0, err0, rc0), (out1, err1, rc1) = outs
    assert rc0 == 0, err0[-3000:]
    assert rc1 == 0, err1[-3000:]
    assert out1 == ""
    direct = smt.run(smt.HistoricalBootstrap.from_csv(), 16384, 12,
                     seed=0, target_amount=1000.0,
                     options=smt.EngineOptions(device="cpu",
                                               chunk_paths=8192))
    lines = out0.strip().splitlines()
    assert lines[0] == "n_simulations: 16384"
    assert lines[2:] == [
        f"mean: {direct.mean:.2f} | std: {direct.std:.2f}",
        f"count_below 1000.0: {direct.count_below} "
        f"({100.0 * direct.prob_below:.4f}%)"]
