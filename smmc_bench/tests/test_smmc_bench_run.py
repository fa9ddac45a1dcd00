"""Whole runs on the CPU at a tiny size, the harness's look for a card
skipped: each cell proves correct, and comes out not correct with its
timed path broken underneath (a step that returns its state unchanged;
half of the batch left out, the mean taken over the rest; an answer
altered where it is produced; the cells run on one chip, so no exchange
between chips exists to leave out). A new configuration, traffic mix and
per-layer metric need new files and a BENCHMARK.json entry only."""

import hashlib
import json
import subprocess
import sys

import pytest
import torch

from smmc_bench import cells
from smmc_bench.run import run_cell
from smmc_bench.tests._tiny import CELLS, REPO, tiny_root

from stock_market_monte_carlo_torch.ops import bands as port_bands
from stock_market_monte_carlo_torch.ops import cuda_engine as port_ce


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("run"))


def _run(root, cell, trace=False, seed=2**31 + 5):
    line = run_cell(root, cell, seed, 0.3, trace, "cpu")
    assert list(line)[-1] == "checks"
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(root, cell):
    line = _run(root, cell)
    assert line["correct"], line
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in cells.cell_metrics(
        cells.load_manifest(root), cell, "end_to_end")}
    assert set(line["metrics"]) == want and "setup_s" in want


def test_traced_run_reports_per_layer_metrics(root):
    line = _run(root, "historical-bands-hist", trace=True)
    assert line["correct"]
    # the CPU has no device: what it can read is the host's
    assert set(line["metrics"]) == {"device_idle_share.bands",
                                    "host_gap_ms.bands",
                                    "launches_per_query.bands"}
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged_state(monkeypatch):
    def month_growth(dev, table, *, n_paths, **kw):
        ones = torch.ones((n_paths // port_ce.TILE_PATHS,
                           port_ce.TILE_ROWS, 128), device=dev)
        return lambda t: ones
    monkeypatch.setattr(port_ce, "month_growth", month_growth)


def _half_batch(monkeypatch):
    for mod, name in ((port_ce, "month_loop_chunk"),
                      (port_bands, "month_hist_chunk"),
                      (port_bands, "month_cdf_chunk")):
        orig = getattr(mod, name)

        def half(*a, _orig=orig, valid, **kw):
            return _orig(*a, valid=valid // 2, **kw)
        monkeypatch.setattr(mod, name, half)


def _altered_answer(monkeypatch):
    orig_stats = port_ce.month_loop_chunk

    def stats(*a, **kw):
        s, hist, finals = orig_stats(*a, **kw)
        hist = hist.clone()
        k = int(hist.argmax())
        hist[k] -= 1
        hist[k + 1] += 1
        return s, hist, finals
    monkeypatch.setattr(port_ce, "month_loop_chunk", stats)
    for name in ("month_hist_chunk", "month_cdf_chunk"):
        orig = getattr(port_bands, name)

        def counts(*a, _orig=orig, **kw):
            out = _orig(*a, **kw).clone()
            out[-1, out.shape[1] // 2] += 1
            return out
        monkeypatch.setattr(port_bands, name, counts)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(root, cell)
    assert line["correct"] is False, line["checks"]


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "smmc_bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_needs_only_new_files(root, tmp_path):
    """A throwaway configuration, traffic mix, limits and per-layer metric,
    added as files beside the others and entries in BENCHMARK.json."""
    new = tiny_root(tmp_path)
    before = _digests(new)
    b = new / "smmc_bench"
    cfg = json.loads((b / "configs" / "gaussian_100M_360.json").read_text())
    cfg["model"]["args"]["mean_pct"] = 0.9
    cfg["name"] = "gaussian_high_mean"
    (b / "configs" / "gaussian_high_mean.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "stats.json").read_text())
    mix.update(call=dict(target_amount=1500.0),
               options=dict(histogram_bins=1022))
    (b / "traffic" / "stats_low_target.json").write_text(json.dumps(mix))
    lim = json.loads((b / "limits" / "historical-stats.json").read_text())
    (b / "limits" / "gaussian-low-target.json").write_text(json.dumps(lim))
    (b / "layer_metrics" / "queries_traced.py").write_text(
        "def read(rec):\n    return rec.n_queries if rec.traced else None\n")
    manifest = json.loads((new / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(
        name="gaussian_high_mean", source="https://example.org/test",
        file="smmc_bench/configs/gaussian_high_mean.json", reduced=[],
        why="a test's throwaway configuration"))
    manifest["workloads"].append(dict(
        name="gaussian-low-target", config="gaussian_high_mean",
        traffic="stats_low_target", chips=1, why="a test's throwaway cell"))
    manifest["per_layer"].append(dict(
        name="queries_traced", unit="queries", better="higher",
        source="program_counter", layer="host chunk loop and merge",
        moves="paths_per_s", workloads=["gaussian-low-target"]))
    (new / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = _digests(new)
    assert {k: after[k] for k in before} == before
    line = run_cell(new, "gaussian-low-target", 9, 0.3, True, "cpu")
    assert line["correct"], line["checks"]
    assert line["metrics"]["queries_traced"]["value"] >= 1
    old = run_cell(new, "historical-stats", 9, 0.3, True, "cpu")
    assert "queries_traced" not in old["metrics"]


def test_needs_a_card_and_the_port(tmp_path):
    """Without a CUDA device, and in a directory that holds only the
    benchmark's files, a run exits non-zero and prints no line."""
    for cwd, env_path in ((REPO, str(REPO)), (tiny_root(tmp_path), "")):
        out = subprocess.run(
            [sys.executable, "-m", "smmc_bench.run", "--workload",
             "historical-stats", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": env_path,
                              "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0 and out.stdout.strip() == "", out
