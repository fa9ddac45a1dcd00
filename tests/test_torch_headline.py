"""The port's headline entry point (``bench/headline.py``) on the CPU: the
rows through the plain versions at 8192 paths x 12 months, the compact
last line, and the independence from jax of the port's modules, its CLI
and ``chip_smoke.py``."""

import json
import math
import os
import socket
import subprocess
import sys

import pytest
import torch

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_torch.bench import headline

ROWS = ("historical_terminal_law", "historical_terminal_law_statsonly",
        "gaussian_terminal_law", "historical_month_loop",
        "historical_month_loop_statsonly", "gaussian_icdf", "gaussian_clt",
        "gaussian_clt_statsonly")


def test_headline_on_the_cpu(capsys):
    record, compact = headline.main(["8192", "12", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines[-1]) < headline.LAST_LINE_MAX
    assert json.loads(lines[-1]) == compact
    assert json.loads(lines[-2]) == record
    assert compact["metric"] == (
        "paths_per_sec_per_chip_12mo_historical_exact_law_hist")
    assert compact["unit"] == "paths/s/chip" and compact["device"] == "cpu"
    assert compact["value"] > 0 and compact["means_ok"] is True
    extra = record["extra"]
    assert tuple(extra["rows"]) == ROWS      # no 1e9 row below 1e8 paths
    for name, row in extra["rows"].items():
        assert math.isfinite(row["mean"]), name
        assert row["mean_rel_err"] <= row["mean_bar"], name
        assert len(row["rep_times_s"]) == (9 if "law" in name else 3)
    for key in ("icdf", "clt", "terminal_law"):
        assert extra[f"mean_rel_err_vs_analytic_{key}"] < headline.MEAN_REL_BAR
    assert "skipped" in extra["device_time"]
    assert record["device"] == {"platform": "cpu", "kind": "cpu",
                                "count": 0}


def test_headline_refuses_a_mesh_and_needs_a_card(monkeypatch):
    """``--mesh 2`` outside torchrun (a world of one process) refuses
    before any run; ``--mesh`` on the cards refuses past the machine's
    card count (tests/test_torch_parallel.py runs the mesh)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE is 1"):
        headline.main(["8192", "12", "--mesh", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="this machine has 1"):
        headline.main(["8192", "12", "--mesh", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.main(["8192", "12"])


def test_bench_modules_leave_jax_out():
    code = ("import sys; "
            "import stock_market_monte_carlo_torch.bench.headline, "
            "stock_market_monte_carlo_torch.bench.roofline, "
            "stock_market_monte_carlo_torch.bench.probes, "
            "stock_market_monte_carlo_torch.ops.calibration, "
            "stock_market_monte_carlo_torch.ops.clt, "
            "stock_market_monte_carlo_torch.ops.byte_planes, "
            "stock_market_monte_carlo_torch.ops.analytic, "
            "stock_market_monte_carlo_torch.ops.reductions, "
            "stock_market_monte_carlo_torch.engine.checkpoint, "
            "stock_market_monte_carlo_torch.engine.progress, "
            "stock_market_monte_carlo_torch.parallel.mesh, "
            "stock_market_monte_carlo_torch.parallel._ranks, "
            "stock_market_monte_carlo_torch.bench.bin_drift, "
            "stock_market_monte_carlo_torch.bench.validation, "
            "stock_market_monte_carlo_torch.bench.fault_drill, "
            "stock_market_monte_carlo_torch.bench.held_outputs, "
            "stock_market_monte_carlo_torch.data.loader, "
            "stock_market_monte_carlo_torch.data._synthetic, "
            "stock_market_monte_carlo_torch.data.fetch, "
            "stock_market_monte_carlo_torch.ops.normal, "
            "stock_market_monte_carlo_torch.utils.io, "
            "stock_market_monte_carlo_torch.utils.timing, "
            "stock_market_monte_carlo_torch.native, "
            "stock_market_monte_carlo_torch.bench.compare, "
            "stock_market_monte_carlo_torch.bench.sweep, "
            "stock_market_monte_carlo_torch.cli.main, "
            "stock_market_monte_carlo_torch.cli.commands, "
            "stock_market_monte_carlo_torch.viz.plots, "
            "stock_market_monte_carlo_torch.viz.live, "
            "stock_market_monte_carlo_torch.viz.live_fan, "
            "stock_market_monte_carlo_torch.viz.gui, "
            "stock_market_monte_carlo_torch.viz.demo, "
            "chip_smoke; "
            "from stock_market_monte_carlo_torch.ops import analytic; "
            "analytic.clt_tail_deviation(1e-5, 0.5, 10 / 12, 12); "
            "from stock_market_monte_carlo_torch.cli.main import main; "
            "main(['--device', 'cpu', 'demo-vector-add', '--n', '8']); "
            "main(['--device', 'cpu', 'benchmark-reduce-mean', '64']); "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith("
            "'stock_market_monte_carlo_tpu')))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=repo,
                         env=env)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _headline_ranks(world, mesh, args=("16384", "12")):
    """``headline ... --device cpu --mesh <mesh>`` in ``world`` processes
    with torchrun's environment (an env:// store on a free loopback port):
    [(status, stdout, stderr), ...] in rank order."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=repo)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "stock_market_monte_carlo_torch.bench."
             "headline", *args, "--device", "cpu", "--mesh", str(mesh)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=repo, env=env))
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=60)
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_headline_mesh_on_the_cpu():
    """``--mesh 2`` over a 2-rank gloo group: rank 0 prints the record and
    the last line, per chip, with n_chips 2; rank 1 prints nothing."""
    (s0, out0, err0), (s1, out1, err1) = _headline_ranks(2, 2)
    assert s0 == 0, err0[-3000:]
    assert s1 == 0, err1[-3000:]
    assert out1 == ""
    lines = out0.strip().splitlines()
    record, compact = json.loads(lines[-2]), json.loads(lines[-1])
    extra = record["extra"]
    assert extra["n_chips"] == 2 and extra["means_ok"] is True
    assert "mesh" in extra["device_time"]["skipped"]
    row = extra["rows"]["historical_terminal_law"]
    assert row["paths_per_sec"] == pytest.approx(
        row["n_paths"] / row["elapsed_s"] / 2)
    assert compact["value"] == row["paths_per_sec"]
    assert compact["unit"] == "paths/s/chip"


def test_headline_mesh_must_be_the_world():
    """``--mesh 3`` under a world of 2 refuses before the process group,
    on both ranks."""
    for status, stdout, stderr in _headline_ranks(2, 3):
        assert status != 0 and stdout == ""
        assert "WORLD_SIZE is 2" in stderr
