"""The plain reference against the port's plain CPU path at a tiny size,
for each mix: the numbers the benchmark compares hold the cells'
limits, and the reference's control (its own arithmetic in bfloat16, in
the program's place) fails them."""

import numpy as np
import pytest
import torch

from smmc_bench import cells, check, reference
from smmc_bench.program import Program
from smmc_bench.reference import paths
from smmc_bench.run import query_seed
from smmc_bench.tests._tiny import CELLS, REPO, load, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("ref"), 8192, 12)


def _gaps(root, cell, seed, dtype=None):
    cfg, mix, table = load(root, cell)
    s = query_seed(seed, 0)
    ref = reference.query(cfg, mix, table, s, "cpu")
    if dtype is None:
        prog = Program(cfg, mix, table, "cpu")
        other = prog.answer(prog(s))
    else:
        other = reference.query(cfg, mix, table, s, "cpu", dtype)
    return check.gaps(mix["check"], other, ref, int(cfg["n_paths"]),
                      mix["call"].get("band_mode") == "cdf")


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(root, cell, seed):
    numbers = _gaps(root, cell, seed)
    ok, rows = check.judge(numbers, cells.limits(REPO, cell))
    assert ok, rows
    exact = ("hist_gap", "below_gap", "counts_gap", "band_gap")
    assert all(numbers[k] == 0.0 for k in exact if k in numbers), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell):
    numbers = _gaps(root, cell, 5, torch.bfloat16)
    ok, rows = check.judge(numbers, cells.limits(REPO, cell))
    assert not ok, rows


@pytest.mark.parametrize("cell", ["historical-stats", "gaussian-bands-cdf"])
def test_reference_blocks_do_not_change_the_answer(root, cell, monkeypatch):
    cfg, mix, table = load(root, cell)
    cfg = dict(cfg, n_paths=20000)
    whole = reference.query(cfg, mix, table, 11, "cpu")
    monkeypatch.setattr(paths, "BLOCK_TILES", 1)
    tiles = reference.query(cfg, mix, table, 11, "cpu")
    for key in whole:
        np.testing.assert_allclose(whole[key], tiles[key], rtol=1e-12)
