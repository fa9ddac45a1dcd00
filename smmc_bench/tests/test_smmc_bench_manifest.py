"""BENCHMARK.json against the files it names and the contract's
characters: every cell resolves to a configuration, a traffic mix and
its limits; every metric to its reader; every algorithm to its work."""

import json
import re

import pytest

from smmc_bench import cells
from smmc_bench.tests._tiny import CELLS, REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_manifest_keys_and_cells_in_order():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert [w["name"] for w in MANIFEST["workloads"]] == list(
        CELLS[:len(MANIFEST["workloads"])])
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves(cell):
    w = cells.find_cell(MANIFEST, cell)
    cfg = cells.config(REPO, w["config"])
    mix = cells.traffic(REPO, w["traffic"])
    lim = cells.limits(REPO, cell)
    assert lim and all(v >= 0 for v in lim.values())
    for name in [cfg["work"], *mix["work"]]:
        assert (REPO / "smmc_bench" / "work" / f"{name}.py").is_file()
    for section in ("end_to_end", "per_layer"):
        assert cells.cell_metrics(MANIFEST, cell, section)
    assert any(m["name"] == "setup_s"
               for m in cells.cell_metrics(MANIFEST, cell, "end_to_end"))


@pytest.mark.parametrize("section,folder", [("end_to_end", "end_to_end"),
                                            ("per_layer", "layer_metrics")])
def test_metrics_resolve(section, folder):
    for m in MANIFEST[section]:
        mod = cells.load_module(REPO, folder, m["name"])
        assert callable(mod.read)
        if section == "per_layer":
            assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
            assert m["layer"] and "\n" not in m["layer"]


def test_names_and_units():
    named = (MANIFEST["configs"] + MANIFEST["workloads"]
             + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    for entry in named:
        assert NAME.fullmatch(entry["name"]), entry["name"]
    for w in MANIFEST["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert len(cfg["source"]) <= 200
    if "table" in cfg["model"]:
        table = cells.read_table(REPO, cfg)
        assert table.size == 1127
