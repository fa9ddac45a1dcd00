"""The counts-below kernel's cell arithmetic (``csrc/bands.cu``: a guess on
the thresholds' log grid, then a walk against the thresholds) through its
plain-torch twin ``ops/bands.py::cdf_cell_twin``, on the CPU.

The twin must give exactly #{k : !(v < thr[k])}, the count the plain
version's strict < implies, on every edge: values on a threshold and one
ulp either side, 0, 1e-38, denormals, huge values, +inf and NaN; B_t so
small that the thresholds tie in float32 and the guess is off by many
cells; B_t so large that the thresholds overflow to +inf and underflow
to 0. ``month_cdf_chunk_plain`` rebuilt on the twin gives its counts
exactly. The kernels' Gaussian draw takes the erfinv's tail for a warp's
group of 32 draws about as often as independent uniforms would have it.
"""

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.bench import probes
from stock_market_monte_carlo_torch.engine import bands as port_bands
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.ops import bands as kb
from stock_market_monte_carlo_torch.ops import cuda_engine as ce

# (A, B) of the log grid: the engine's scale, thresholds tied in float32,
# thresholds past float32 at both ends, a grid below 1
COEFFICIENTS = {
    "grid": (7.3, 0.05),
    "tied": (7.3, 1e-7),
    "overflow": (7.3, 10.0),
    "below_one": (-3.0, 0.2),
}


def _kappas(k):
    """The guard rows' fractional k of ``cdf_coefficients``."""
    centers, scales = np.zeros(2), np.ones(2)
    return port_bands.cdf_coefficients(centers, scales, k, 1.0)[2:4]


def _thresholds(a, b, k):
    klo, khi = _kappas(k)
    coef = torch.full((1,), a, dtype=torch.float32)
    return kb.cdf_thresholds(coef, torch.full((1,), b, dtype=torch.float32),
                             klo, khi, k)[0]


def _edge_values(thr, rng):
    """Each threshold and its neighbouring floats, the special values, and
    log-uniform values across the thresholds' span."""
    t = thr.numpy()
    finite = t[np.isfinite(t)]
    near = np.concatenate([t, np.nextafter(t, np.float32(-np.inf)),
                           np.nextafter(t, np.float32(np.inf))])
    special = np.array([0.0, -0.0, 1e-38, 1e-40, 1.4e-45, 1e-37, 1.0,
                        3.4e38, np.inf, np.nan, -1.0], np.float32)
    lo = np.log(max(float(finite[finite > 0].min()), 1e-38)) - 2.0
    hi = np.log(float(finite.max())) + 2.0
    spread = np.exp(rng.uniform(lo, min(hi, 88.0), 4000)).astype(np.float32)
    return torch.as_tensor(np.concatenate([near, special, spread]
                                          ).astype(np.float32))


def _count_not_below(v, thr):
    return (~(v[:, None] < thr[None, :])).sum(dim=1)


@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("name", sorted(COEFFICIENTS))
def test_twin_counts_thresholds_not_below_on_edges(name, k):
    a, b = COEFFICIENTS[name]
    thr = _thresholds(a, b, k)
    v = _edge_values(thr, np.random.default_rng(k))
    got = kb.cdf_cell_twin(v, thr, np.float32(a), np.float32(b))
    want = _count_not_below(v, thr)
    assert got.dtype == torch.int64
    assert torch.equal(got, want)
    # NaN and +inf are not below any threshold; 0 is not below those at 0
    special = torch.tensor([np.nan, np.inf, 0.0], dtype=torch.float32)
    assert kb.cdf_cell_twin(special, thr, a, b).tolist() == [
        k, k, int((thr <= 0).sum())]


def test_tied_thresholds_reach_the_walk():
    """With B_t = 1e-7 the thresholds tie in float32 (five to a value at
    A = 7.3) and the guess is off by more than the one cell its check
    covers, so the twin's walk, not its guess, decides."""
    k = 32
    a, b = COEFFICIENTS["tied"]
    thr = _thresholds(a, b, k)
    v = _edge_values(thr, np.random.default_rng(1))
    v = v[torch.isfinite(v) & (v > 0)]
    gc = kb.cdf_guess_coefficients(torch.tensor([a], dtype=torch.float32),
                                   torch.tensor([b], dtype=torch.float32))[0]
    x = torch.floor((torch.log2(v) - gc[0]) * gc[1])
    guess = torch.clamp(x, 1.0, float(k - 1)).long()
    exact = kb.cdf_cell_twin(v, thr, a, b)
    assert torch.equal(exact, _count_not_below(v, thr))
    assert int((guess - exact).abs().max()) >= 2


def _plain_on_twin(table, keep, coef_a, coef_b, *, kappa_lo, kappa_hi,
                   n_thresholds, valid, coef_b_host=None, **kw):
    """``month_cdf_chunk_plain`` with each value's count taken by the twin:
    per month, the histogram of the cells j, cumulated over j <= k."""
    thr = kb.cdf_thresholds(coef_a, coef_b, kappa_lo, kappa_hi, n_thresholds)
    rows = []
    for t, total in kb._month_values(coef_a.device, table, keep, **kw):
        j = kb.cdf_cell_twin(total.reshape(-1)[:valid], thr[t], coef_a[t],
                             coef_b[t])
        cells = torch.bincount(j, minlength=n_thresholds + 1)
        rows.append(torch.cumsum(cells[:n_thresholds], 0))
    return torch.stack(rows).to(torch.int32)


@pytest.mark.parametrize("kind", ["historical", "gaussian"])
@pytest.mark.parametrize("strategy", ["none", "fixed_percent"])
def test_plain_on_twin_matches_plain(kind, strategy):
    t, k = 12, 16
    model = (smt.HistoricalBootstrap.from_csv() if kind == "historical"
             else smt.GaussianReturns())
    strat = (smt.NoWithdrawal() if strategy == "none"
             else smt.FixedPercentWithdrawal(0.4))
    centers, scales = port_bands.band_grid(model, strat, t, 1000.0)
    ca, cb, klo, khi, _, _ = port_bands.cdf_coefficients(centers, scales, k,
                                                         1000.0)
    cpu = torch.device("cpu")
    table, draw = ce.draw_operands(model, cpu)
    keep = (None if strategy == "none" else torch.as_tensor(
        port_engine._keep_factors_np(strat, t)))
    ops = (table, keep, torch.as_tensor(ca), torch.as_tensor(cb))
    kw = dict(n_periods=t, seed_base=port_engine._segment_base(4, 0),
              tile0=7, valid=2 * 8192 - 501, n_paths=2 * 8192, v0=1000.0,
              kappa_lo=klo, kappa_hi=khi, n_thresholds=k, coef_b_host=cb,
              **draw)
    want = kb.month_cdf_chunk_plain(*ops, **kw)
    got = _plain_on_twin(*ops, **kw)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(kb.month_cdf_chunk(*ops, **kw), want)


def test_erfinv_tail_share_of_warp_groups():
    """A (warp item, month, path slot) group of the band kernels' Gaussian
    draw takes the erfinv's tail where any of its 32 lanes has w >= 5:
    over 4 tiles x 120 months of the plain counter stream, within a few
    tenths of a point of 1 - (1 - 0.0033747)^32 = 10.25 % of groups, and
    of 0.33747 % of single draws."""
    got = probes.erfinv_tail_share(0x9E3779B9, tile0=37, n_tiles=4,
                                   n_periods=120)
    assert got["groups"] == 4 * 32 * 8 * 120
    assert got["draws"] == 32 * got["groups"]
    assert abs(got["draw_share_independent"] - 0.0033747) < 1e-7
    assert abs(got["group_share_independent"] - 0.10253) < 1e-5
    assert abs(got["group_share"] - got["group_share_independent"]) < 0.003
    assert abs(got["draw_share"] - got["draw_share_independent"]) < 0.0002
