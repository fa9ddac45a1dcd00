"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix, limits and metric readers, each found by its name.

A configuration is ``smmc_bench/configs/<config>.json``, a traffic mix
``smmc_bench/traffic/<traffic>.json``, a cell's limits
``smmc_bench/limits/<workload>.json``, a metric's reader
``smmc_bench/end_to_end/<name>.py`` or ``smmc_bench/layer_metrics/
<name>.py``, an algorithm's work ``smmc_bench/work/<name>.py``. Adding any
of them adds files and a ``BENCHMARK.json`` entry and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import numpy as np

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
BENCH = "smmc_bench"


def load_manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(manifest: dict, workload: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def _json(root: Path, folder: str, name: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"bad name {name!r}")
    with open(root / BENCH / folder / f"{name}.json") as f:
        return json.load(f)


def config(root: Path, name: str) -> dict:
    return _json(root, "configs", name)


def traffic(root: Path, name: str) -> dict:
    return _json(root, "traffic", name)


def limits(root: Path, workload: str) -> dict:
    return _json(root, "limits", workload)


def load_module(root: Path, folder: str, name: str):
    """The module ``smmc_bench/<folder>/<name>.py``, loaded by its path
    (a metric's name may hold '.' and '-')."""
    if not NAME.fullmatch(name):
        raise ValueError(f"bad name {name!r}")
    path = root / BENCH / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{BENCH}.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, workload: str, section: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell reports: those without ``workloads``, or listing it."""
    return [m for m in manifest[section]
            if workload in m.get("workloads", [workload])]


def read_table(root: Path, config_: dict) -> np.ndarray:
    """The configuration's returns table, float32, read from its frozen
    copy by its own path: the ``returns`` column, rows without a number
    skipped. Checked against the configuration's row count."""
    import csv

    path = root / BENCH / config_["model"]["table"]
    values = []
    with open(path, newline="") as f:
        rows = csv.reader(f)
        col = next(rows).index("returns")
        for row in rows:
            try:
                v = float(row[col])
            except (IndexError, ValueError):
                continue
            if v == v:
                values.append(v)
    table = np.asarray(values, np.float32)
    if table.size != int(config_["model"]["table_rows"]):
        raise ValueError(f"{path} holds {table.size} rows, the configuration "
                         f"says {config_['model']['table_rows']}")
    return table
