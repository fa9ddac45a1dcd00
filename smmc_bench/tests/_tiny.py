"""Helpers of the benchmark's CPU tests: a checkout of the benchmark at a
tiny size, run on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
CELLS = ("historical-stats", "gaussian-stats-pct", "gaussian-bands-cdf",
         "historical-bands-hist")

torch.set_num_threads(2)


def tiny_root(tmp: Path, n_paths: int = 20000, n_periods: int = 12) -> Path:
    """A copy of BENCHMARK.json and ``smmc_bench/`` under ``tmp`` with
    every configuration cut to ``n_paths`` x ``n_periods``."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "smmc_bench", root / "smmc_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "smmc_bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(n_paths=n_paths, n_periods=n_periods)
        path.write_text(json.dumps(cfg))
    return root


def load(root: Path, workload: str):
    """(config, traffic, table) of a cell under ``root``."""
    from smmc_bench import cells

    cell = cells.find_cell(cells.load_manifest(root), workload)
    cfg = cells.config(root, cell["config"])
    mix = cells.traffic(root, cell["traffic"])
    table = (cells.read_table(root, cfg)
             if "table" in cfg["model"] else None)
    return cfg, mix, table
