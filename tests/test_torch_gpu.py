"""The CUDA kernels against their plain PyTorch versions on the card, at
shapes the smoke test does not reach: ragged chunks at a nonzero tile
offset, the hostile 97-row table, a 20000-row table (whose shared-memory
table needs the opt-in above 48 KB), odd histogram sizes and no
histogram. Also the wrappers' input checks and launch counters.

Skipped without a CUDA device. On the card (no jax there, so without the
repository's conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.data.loader import (
    HOSTILE_CSV,
    SYNTHETIC_CSV,
    read_historical_returns,
)
from stock_market_monte_carlo_torch.ops import cuda_engine as ce

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(name):
    if name == "n1127":
        return read_historical_returns(SYNTHETIC_CSV)
    if name == "hostile_n97":
        return read_historical_returns(HOSTILE_CSV)
    return np.random.default_rng(3).uniform(-6.0, 6.5, 20000).astype(
        np.float32)


def _month_kw(strategy, n_table, n_periods, hb, with_hist):
    return dict(n_table=n_table, strategy=strategy, amount=4.0,
                n_periods=n_periods, seed_base=0x9E3779B9, tile0=37,
                valid=2 * 8192 + 1001, n_paths=4 * 8192, v0=1000.0,
                target=990.0, shift=1.01, log_lo=float(np.log(300.0)),
                inv_w=float(np.float32((hb - 2) / np.log(10.0))), hb=hb,
                with_hist=with_hist, keep_finals=True)


def _assert_kernel_matches_plain(k_out, p_out, finals_rel=0.0):
    torch.cuda.synchronize()
    sk, sp = k_out[0].cpu().numpy(), p_out[0].cpu().numpy()
    np.testing.assert_array_equal(sk[[0, 5, 6, 7]], sp[[0, 5, 6, 7]])
    np.testing.assert_allclose(sk[[1, 2, 3, 4, 8]], sp[[1, 2, 3, 4, 8]],
                               rtol=1e-6, atol=1e-6 * np.abs(sp[2]))
    hk, hp = k_out[1].cpu().numpy(), p_out[1].cpu().numpy()
    assert hk.sum() == hp.sum()
    assert np.abs(hk - hp).max() <= 2
    np.testing.assert_allclose(k_out[2].cpu().numpy(),
                               p_out[2].cpu().numpy(), rtol=finals_rel,
                               atol=0)


@pytest.mark.parametrize("table_name", ["n1127", "hostile_n97", "n20000"])
@pytest.mark.parametrize("strategy", ["none", "fixed_percent",
                                      "fixed_amount"])
@pytest.mark.parametrize("hb,with_hist", [(4096, True), (102, True),
                                          (4096, False)])
def test_month_loop_kernel_matches_plain(cuda, table_name, strategy, hb,
                                         with_hist):
    flat, n = ce._pad_table(_table(table_name))
    table = torch.as_tensor(flat, device=cuda)
    keep = torch.full((24,), 0.995, dtype=torch.float32, device=cuda)
    kw = _month_kw(strategy, n, 24, hb, with_hist)
    _assert_kernel_matches_plain(ce.month_loop_chunk(table, keep, **kw),
                                 ce.month_loop_chunk_plain(table, keep, **kw))


@pytest.mark.parametrize("keep_finals", [True, False])
@pytest.mark.parametrize("hb", [4096, 102])
def test_law_kernel_matches_plain(cuda, keep_finals, hb):
    from stock_market_monte_carlo_torch.ops.terminal_law import (
        LAW_ZMAX,
        fit_terminal_law,
    )

    fit = fit_terminal_law(smt.GaussianReturns(), smt.NoWithdrawal(), 120,
                           1000.0)
    law = torch.as_tensor(fit.operand(), device=cuda)
    kw = dict(seed_base=0x80000001, tile0=5, valid=3 * 8192 + 17,
              n_paths=4 * 8192, v0=1000.0, target=1500.0, shift=1.8,
              inv_zmax=1.0 / LAW_ZMAX, log_lo=float(np.log(200.0)),
              inv_w=float(np.float32((hb - 2) / np.log(80.0))), hb=hb,
              with_hist=True, keep_finals=True)
    p_out = ce.law_chunk_plain(law, **kw)
    k_out = ce.law_chunk(law, **dict(kw, keep_finals=keep_finals))
    if not keep_finals:
        assert k_out[2] is None
        k_out = (k_out[0], k_out[1], p_out[2])
    _assert_kernel_matches_plain(k_out, p_out, finals_rel=1e-6)


def test_engine_on_cuda_matches_cpu(cuda):
    model = smt.HistoricalBootstrap.from_csv()
    strategy = smt.FixedPercentWithdrawal(0.3)
    args = (model, 3 * 8192 + 123, 12)
    kw = dict(seed=4, strategy=strategy, target_amount=1000.0)
    got = smt.simulate_stats(*args, keep_final_values=True,
                             options=smt.EngineOptions(chunk_paths=8192),
                             **kw)
    want = smt.simulate_stats(*args, keep_final_values=True,
                              options=smt.EngineOptions(chunk_paths=8192,
                                                        device="cpu"), **kw)
    np.testing.assert_array_equal(got.final_values, want.final_values)
    assert got.moments.count_below == want.moments.count_below
    assert got.moments.mean == pytest.approx(want.moments.mean, rel=1e-6)
    np.testing.assert_array_equal(got.histogram_counts.sum(),
                                  want.histogram_counts.sum())


def test_wrappers_check_inputs_and_count_launches(cuda):
    flat, n = ce._pad_table(_table("n1127"))
    table = torch.as_tensor(flat, device=cuda)
    keep = torch.ones((12,), dtype=torch.float32, device=cuda)
    kw = _month_kw("none", n, 12, 4096, True)
    ce.reset_launch_counts()
    ce.month_loop_chunk_plain(table, keep, **kw)
    assert ce.LAUNCHES["month_loop"] == 0
    ce.month_loop_chunk(table, keep, **kw)
    assert ce.LAUNCHES["month_loop"] == 1
    with pytest.raises(TypeError):
        ce.month_loop_chunk(table.double(), keep, **kw)
    with pytest.raises(ValueError):
        ce.month_loop_chunk(table, keep[:6], **kw)
    with pytest.raises(ValueError):
        ce.month_loop_chunk(table, keep, **dict(kw, hb=ce.MAX_HIST_CELLS + 2))
    assert ce.LAUNCHES["month_loop"] == 1
