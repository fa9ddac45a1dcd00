"""The terminal-law kernel's host side (``csrc/terminal_law.cu``,
``ops/cuda_engine.py``) on the CPU: the CPU twin of the kernel's finish
(``law_stats_twin``), which reduces the blocks' float64 stats rows in the
kernel's order, against the wrappers' torch reduction
(``_reduce_partials``) and against that order written out; the launcher's
guard on the operand length, which refuses before anything is launched
(the kernel has the length as a constant); and the grid the launcher
takes. The kernel itself runs only on the card
(``tests/test_torch_gpu.py``)."""

import math

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_torch.ops import terminal_law as tlaw

# blocks of a chunk's grid: one, around a warp's 32 lanes, the main path's
# 1056 (132 SMs x 8) and an odd count
N_BLOCKS = (1, 31, 32, 33, 1056, 1057)


def _rows(n_blocks, seed):
    """(n_blocks, 8) float64 block rows as the law kernel writes them:
    power sums of ~2^14 float32 terms of either sign, min and max of V/v0,
    counts below, the withdrawn total 0."""
    rng = np.random.default_rng(seed)
    rows = np.empty((n_blocks, 8))
    rows[:, 0] = rng.normal(0.0, 30.0, n_blocks)
    rows[:, 1] = rng.uniform(1e3, 5e4, n_blocks)
    rows[:, 2] = rng.normal(0.0, 2e5, n_blocks)
    rows[:, 3] = rng.uniform(1e4, 1e7, n_blocks)
    rows[:, 4] = rng.uniform(0.05, 1.0, n_blocks).astype(np.float32)
    rows[:, 5] = rng.uniform(2.0, 90.0, n_blocks).astype(np.float32)
    rows[:, 6] = rng.integers(0, 1 << 14, n_blocks)
    rows[:, 7] = 0.0
    return torch.as_tensor(rows)


@pytest.mark.parametrize("n_blocks", N_BLOCKS)
def test_stats_twin_matches_reduce_partials(n_blocks):
    """Path count, min, max, count below and the withdrawn 0 exact; the
    power sums within 1e-12 of torch's order, before the cast."""
    rows = _rows(n_blocks, n_blocks)
    valid = 16_777_216 - 17
    got = ce.law_stats_twin(rows, valid)
    want = ce._reduce_partials(rows, valid, torch.float64)
    assert got.dtype == want.dtype == torch.float64
    assert torch.equal(got[[0, 5, 6, 7, 8]], want[[0, 5, 6, 7, 8]])
    assert got[8] == 0.0
    rel = ((got[1:5] - want[1:5]).abs() / want[1:5].abs()).max()
    assert float(rel) <= 1e-12


@pytest.mark.parametrize("n_blocks", [1, 33, 1056])
def test_stats_twin_order(n_blocks):
    """The twin's order written out with Python floats: lane l of a warp
    sums rows l, l + 32, ... from 0, then the lanes' sums in lane order;
    bit for bit."""
    rows = _rows(n_blocks, 7 + n_blocks)
    got = ce.law_stats_twin(rows, 5)
    cols = rows.numpy()
    for k in (0, 1, 2, 3, 6, 7):
        lanes = []
        for lane in range(32):
            acc = 0.0
            for r in range(lane, n_blocks, 32):
                acc += float(cols[r, k])
            lanes.append(acc)
        tot = lanes[0]
        for v in lanes[1:]:
            tot += v
        assert float(got[1 + k]) == tot
    assert float(got[5]) == float(cols[:, 4].min())
    assert float(got[6]) == float(cols[:, 5].max())
    assert float(got[0]) == 5.0


def test_stats_twin_order_matters():
    """Rows whose float64 sum depends on the order (1e16 beside ones):
    the twin's stays within the float64 summation bound of the exact
    sum."""
    rows = torch.zeros((64, 8), dtype=torch.float64)
    rows[:, 0] = torch.tensor([1e16 if r % 32 == 0 else 1.0
                               for r in range(64)])
    rows[:, 4] = 1.0
    rows[:, 5] = 1.0
    got = float(ce.law_stats_twin(rows, 1)[1])
    exact = math.fsum(rows[:, 0].tolist())
    assert abs(got - exact) <= 64 * 2.0 ** -52 * 2e16


def _law_kw(**kw):
    return dict(dict(seed_base=5, tile0=0, valid=8192, n_paths=8192,
                     v0=1000.0, target=1500.0, shift=1.8,
                     inv_zmax=1.0 / tlaw.LAW_ZMAX, lo=200.0,
                     log_lo=float(np.log(200.0)), inv_w=1000.0, hb=4096,
                     with_hist=True, keep_finals=False), **kw)


def _operand():
    return tlaw.fit_terminal_law(smt.GaussianReturns(), smt.NoWithdrawal(),
                                 60, 1000.0).operand()


@pytest.mark.parametrize("n", [tlaw.LAW_OP_LEN - 1, tlaw.LAW_OP_LEN + 1,
                               17])
def test_operand_length_refused_before_launch(n):
    """A law operand of another length than LAW_OP_LEN is refused by the
    launcher on the host, before the device is looked at; so is a host
    copy of another length, or none."""
    op = _operand()
    law = torch.zeros((n,), dtype=torch.float32)
    ce.reset_launch_counts()
    with pytest.raises(ValueError, match=f"{n} elements, expected "
                                         f"{tlaw.LAW_OP_LEN}"):
        ce.law_launcher(law, **_law_kw(law_host=np.zeros(n, np.float32)))
    good = torch.as_tensor(op)
    with pytest.raises(ValueError, match="law_host has shape"):
        ce.law_launcher(good, **_law_kw(law_host=np.resize(op, n)))
    with pytest.raises(ValueError, match="needs law_host"):
        ce.law_launcher(good, **_law_kw())
    # the right lengths pass the guard and meet the device check
    with pytest.raises(ValueError, match="no terminal-law kernel"):
        ce.law_launcher(good, **_law_kw(law_host=op))
    assert ce.LAUNCHES["law"] == 0


def test_operand_host_copy_is_the_operand():
    """The kernel's parameter copy holds the operand's float32 values."""
    op = _operand()
    host = ce.law_operand_host(torch.as_tensor(op), op)
    assert len(host) == tlaw.LAW_OP_LEN
    np.testing.assert_array_equal(np.array(host[:], np.float32), op)


def test_plain_ignores_host_copy():
    """On the CPU the wrapper runs the plain version, with or without the
    host copy, to the same outputs."""
    op = _operand()
    law = torch.as_tensor(op)
    a = ce.law_chunk(law, **_law_kw(keep_finals=True, law_host=op))
    b = ce.law_chunk(law, **_law_kw(keep_finals=True))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("valid", [1, 19, 3 * 8192 + 17, 1 << 24,
                                   100_000_000 - 5 * (1 << 24)])
@pytest.mark.parametrize("blocks_per_sm", [8, 16, 32])
def test_grid_covers_the_chunk(valid, blocks_per_sm):
    """The launcher's grid on a 132-SM card: at most blocks_per_sm a SM,
    at least one unit of 4 x 256 paths a block; the blocks' units (block
    b takes units b, b + grid, ...) cover the chunk once, and a unit lies
    in one 8192-path RNG tile."""
    n_blocks = ce._launch_geometry(132, valid, ce.LAW_UNIT_PATHS,
                                   blocks_per_sm)
    n_units = -(-valid // ce.LAW_UNIT_PATHS)
    assert 1 <= n_blocks <= min(n_units, 132 * blocks_per_sm)
    units = torch.cat([torch.arange(b, n_units, n_blocks)
                       for b in range(n_blocks)])
    assert torch.equal(torch.sort(units).values, torch.arange(n_units))
    assert ce.TILE_PATHS % ce.LAW_UNIT_PATHS == 0
