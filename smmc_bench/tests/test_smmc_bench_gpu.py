"""On the card: the reference against the port's kernels for each mix at
a chunk and a ragged second one (2^24 + 20000 paths) of 12 months, and
the control failing the cells' limits there. Skips without a CUDA
device; run on the card with

    python -m pytest -p no:cacheprovider smmc_bench/tests -m gpu
"""

import pytest
import torch

from smmc_bench import cells, check, reference
from smmc_bench.program import Program
from smmc_bench.tests._tiny import CELLS, REPO, load, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tiny_root(tmp_path_factory.mktemp("gpu"), (1 << 24) + 20000, 12)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_reference_against_the_kernels(root, cell):
    cfg, mix, table = load(root, cell)
    prog = Program(cfg, mix, table, "cuda")
    answer = prog.answer(prog(2**31 + 9))
    ref = reference.query(cfg, mix, table, 2**31 + 9, "cuda")
    ctl = reference.query(cfg, mix, table, 2**31 + 9, "cuda",
                          torch.bfloat16)
    n, cdf = int(cfg["n_paths"]), mix["call"].get("band_mode") == "cdf"
    limits = cells.limits(REPO, cell)
    ok, rows = check.judge(check.gaps(mix["check"], answer, ref, n, cdf),
                           limits)
    assert ok, rows
    ok, rows = check.judge(check.gaps(mix["check"], ctl, ref, n, cdf),
                           limits)
    assert not ok, rows
