"""The band-histogram kernel (``csrc/bands.cu`` ``hist_kernel``) in its CPU
twins: its split of a chunk (the launch plan: windows of months whose
counts and cell edges fit in shared memory beside the table, the grid; the
walk of windows x warp items, which must bin every (path, month) of the
chunk's valid paths once and no other) and its cell arithmetic (the cell
edges, bisected over the float32 bit patterns, and the guess that the
edges check and correct), against the plain version's cell formula. The
kernel itself runs only on the card (``tests/test_torch_gpu.py``, which
also checks that the card's log does not decrease, which the edges
need)."""

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.engine import bands as bands_eng
from stock_market_monte_carlo_torch.ops import bands as kb

MONTHS = 360
CELLS = 1026
# the most bins whose month of cells and edges fits in a block's shared
# memory (the Gaussian draw, no table): 4 * (2 * 29056 - 1) bytes
MOST_BINS = 29054
TINY = np.float32(1e-37)


@pytest.mark.parametrize("valid", [1, 255, 257, 8191, (1 << 24) - 1])
@pytest.mark.parametrize("full_grid", [False, True])
def test_hist_walk_bins_each_path_month_once(valid, full_grid):
    """At ragged chunks, with the plan's grid and with the card's whole
    grid (132 blocks of 32 warps: most warps of a small chunk walk no
    item): the valid paths are binned in every month once, the paths past
    `valid` that a warp item simulates never."""
    plan = kb.hist_plan_twin(valid, MONTHS, CELLS, 1127)
    assert (plan["window"], plan["windows"]) == (26, 14)
    grid = 132 if full_grid else plan["grid"]
    counted = kb.hist_work_twin(valid, MONTHS, plan["window"], grid)
    assert counted.numel() == -(-valid // 256) * 256
    assert bool((counted[:valid] == MONTHS).all())
    assert int(counted[valid:].abs().sum()) == 0


@pytest.mark.parametrize("n_periods,n_cells,n_table,want", [
    (360, 1026, 1127, (26, 14)),    # 27 months fit, evened out
    (360, 1026, 0, (28, 13)),       # the Gaussian draw: 28 fit
    (360, 4095, 1127, (6, 60)),
    (37, 14003, 0, (2, 19)),        # a last window of one month
    (5, 28002, 1127, (1, 5)),
    (12, 1026, 1127, (12, 1)),      # every month in one window
])
def test_hist_plan_windows(n_periods, n_cells, n_table, want):
    plan = kb.hist_plan_twin(1 << 24, n_periods, n_cells, n_table)
    assert (plan["window"], plan["windows"]) == want
    assert plan["window"] * plan["windows"] >= n_periods
    assert (plan["window"] - 1) * plan["windows"] < n_periods
    assert plan["grid"] == 132 and plan["threads"] == 1024


def test_hist_plan_grid_and_limits():
    """Fewer blocks than the card holds for a chunk of few warp items; a
    month that does not fit beside the table is refused."""
    assert kb.hist_plan_twin(3 * 8192, 12, CELLS, 1127)["grid"] == 3
    assert kb.hist_plan_twin(1, 12, CELLS, 1127)["grid"] == 1
    with pytest.raises(ValueError, match="does not fit"):
        kb.hist_plan_twin(8192, 12, 28481, 1127)
    assert kb.hist_plan_twin(8192, 12, 28480, 1127)["window"] == 1


def _grid(n_bins, months=(1, 120, 360), model=None, strategy=None):
    """float32 (A_t, B_t) tensors of simulate_bands' histogram grid at the
    given months."""
    model = model or smt.HistoricalBootstrap.from_csv()
    centers, scales = bands_eng.band_grid(model, strategy or
                                          smt.NoWithdrawal(), 360, 1000.0)
    ca, cb, _ = bands_eng.hist_coefficients(centers, scales, n_bins, 1000.0)
    idx = [t - 1 for t in months]
    return torch.as_tensor(ca[idx]), torch.as_tensor(cb[idx])


def _probes(edges):
    """Each edge, the floats either side of it, and the values whose cells
    are special: 0, 1e-38 and denormals (below the 1e-37 floor), 1e-37,
    3e38, the largest float, +inf and NaN."""
    bits = edges.view(torch.int32)
    near = torch.cat([edges,
                      (bits - 1).view(torch.float32),
                      (bits + 1).clamp(max=0x7F800000).view(torch.float32)])
    special = torch.tensor([0.0, 1e-38, 1e-40, 1e-45, float(TINY), 3e38,
                            float(np.finfo(np.float32).max), float("inf"),
                            float("nan")], dtype=torch.float32)
    return torch.cat([near[torch.isfinite(near) | torch.isinf(near)],
                      special])


@pytest.mark.parametrize("n_bins", [CELLS - 2, MOST_BINS])
def test_hist_edges_are_the_cells_least_values(n_bins):
    """Edge c-1 of a month is the least float (from 1e-37) whose cell is
    at least c: its cell is, the float before it is not (or it is 1e-37)."""
    ca, cb = _grid(n_bins)
    edges = kb.hist_edges(ca, cb, n_bins)
    assert edges.shape == (3, n_bins + 1) and edges.dtype == torch.float32
    c = torch.arange(1, n_bins + 2)
    at = kb.hist_cells(edges, ca[:, None], cb[:, None], n_bins)
    prev = (edges.view(torch.int32) - 1).view(torch.float32)
    below = kb.hist_cells(prev, ca[:, None], cb[:, None], n_bins)
    assert bool((at >= c).all())
    assert bool(((below < c) | (edges == TINY)).all())
    assert bool((edges[:, 1:] >= edges[:, :-1]).all())


@pytest.mark.parametrize("n_bins", [CELLS - 2, MOST_BINS])
def test_hist_cell_twin_matches_the_cell_formula(n_bins):
    """The kernel's guess, check and walk against the month's edges give
    the plain version's cell of every probe: the edges, one ulp either
    side, 0, 1e-38, denormals, 1e-37, 3e38, the largest float, +inf, NaN,
    and log-normal values about the grid."""
    ca, cb = _grid(n_bins)
    edges = kb.hist_edges(ca, cb, n_bins)
    rng = np.random.default_rng(5)
    spread = torch.as_tensor(np.exp(rng.normal(7.0, 2.0, 20000)).astype(
        np.float32))
    for t in range(ca.numel()):
        v = torch.cat([_probes(edges[t]), spread])
        want = kb.hist_cells(v, ca[t], cb[t], n_bins)
        assert torch.equal(kb.hist_cell_twin(v, edges[t], ca[t], cb[t]),
                           want)
    # NaN and values under the floor in the cell of 1e-37, +inf in the top
    v = torch.tensor([float("nan"), 0.0, 1e-45, float("inf")])
    got = kb.hist_cell_twin(v, edges[0], ca[0], cb[0])
    floor = kb.hist_cells(torch.tensor([float(TINY)]), ca[0], cb[0], n_bins)
    assert got.tolist() == [int(floor)] * 3 + [n_bins + 1]


@pytest.mark.parametrize("a_t,b_t", [(1e-3, 1e6), (1e-3, -1e6), (1e4, 0.0),
                                     (3.0, -2.5)])
def test_hist_edges_at_adversarial_coefficients(a_t, b_t):
    """Grids that put every value in the top cell (every edge at 1e-37),
    every finite value in cell 0 (every edge at +inf), cells narrower than
    the floats' spacing near 1 (tied edges) and a coarse one: the twin
    still gives the formula's cell."""
    ca = torch.tensor([a_t], dtype=torch.float32)
    cb = torch.tensor([b_t], dtype=torch.float32)
    edges = kb.hist_edges(ca, cb, CELLS - 2)
    if b_t == 1e6:
        assert bool((edges == TINY).all())
    if b_t == -1e6:
        assert bool(torch.isinf(edges).all())
    v = torch.cat([_probes(edges[0]),
                   torch.exp(torch.linspace(-90.0, 88.0, 5001))])
    assert torch.equal(kb.hist_cell_twin(v, edges[0], ca[0], cb[0]),
                       kb.hist_cells(v, ca[0], cb[0], CELLS - 2))


def test_hist_guess_is_the_cell_in_exact_arithmetic():
    """The guess coefficients (a_t, c_t) put floor((log2 V - a_t) * c_t)
    within a cell of floor(ln V * A_t + B_t) + 1 on the grid's values."""
    ca, cb = _grid(CELLS - 2)
    gc = kb.hist_guess_coefficients(ca, cb)
    v = torch.exp(torch.linspace(5.0, 9.0, 4001, dtype=torch.float64))
    guess = torch.floor((torch.log2(v)[None, :] - gc[:, :1].double())
                        * gc[:, 1:].double())
    exact = torch.floor(torch.log(v)[None, :] * ca[:, None].double()
                        + cb[:, None].double()) + 1
    assert float((guess - exact).abs().max()) <= 1.0
