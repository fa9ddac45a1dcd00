"""The port's headline entry point (``bench/headline.py``) on the CPU: the
rows through the plain versions at 40000 paths x 12 months, the compact
last line, and the modules' independence from jax."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from stock_market_monte_carlo_torch.bench import headline

ROWS = ("historical_terminal_law", "historical_terminal_law_statsonly",
        "gaussian_terminal_law", "historical_month_loop",
        "historical_month_loop_statsonly", "gaussian_icdf", "gaussian_clt",
        "gaussian_clt_statsonly")


def test_headline_on_the_cpu(capsys):
    record, compact = headline.main(["40000", "12", "--device", "cpu"])
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
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        headline.main(["8192", "12", "--mesh", "2", "--device", "cpu"])
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
            "stock_market_monte_carlo_torch.bench.validation, "
            "stock_market_monte_carlo_torch.bench.fault_drill, "
            "stock_market_monte_carlo_torch.bench.held_outputs, "
            "stock_market_monte_carlo_torch.data.loader; "
            "from stock_market_monte_carlo_torch.ops import analytic; "
            "analytic.clt_tail_deviation(1e-5, 0.5, 10 / 12, 12); "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith("
            "'stock_market_monte_carlo_tpu')))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=repo)
    assert out.stdout.strip() == "[]"
