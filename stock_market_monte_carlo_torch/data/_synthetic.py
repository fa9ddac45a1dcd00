"""Generator for the vendored synthetic S&P500-like monthly-returns CSV
(numpy only; the port's copy of ``stock_market_monte_carlo_tpu/data/
_synthetic.py``, writing the port's vendored tables byte for byte).

The reference's real data file (data/SP500_monthly_returns.csv, produced by
python/get_data.py from Yahoo Finance, 1928-01..2021-12, ~1127 usable rows)
is gitignored upstream and needs the network to fetch. This module
deterministically generates a stand-in with the same schema, the same row
count, and S&P500-like moments (monthly mean ~0.54%, std ~4.8%, mild negative
skew and fat tails via a two-regime mixture), so tests and demos are hermetic.

Run ``python -m stock_market_monte_carlo_torch.data._synthetic`` to regenerate.
"""

from __future__ import annotations

import numpy as np

# 1928-01 .. 2021-12 monthly, matching get_data.py's date range: 94y * 12mo
# price points whose pct_change leaves N_MONTHS - 1 = 1127 usable returns —
# the reference's row count (and the shmem table size hard-coded in its
# kernels, src/simulations.cu:123).
N_MONTHS = 94 * 12
N_RETURNS = N_MONTHS - 1
SEED = 20260816


def synthetic_monthly_returns(n_months: int = N_RETURNS,
                              seed: int = SEED) -> np.ndarray:
    """Percent monthly returns with S&P500-like moments. Deterministic."""
    rng = np.random.default_rng(seed)
    # Two-regime mixture: calm bull regime + volatile bear regime, with
    # sticky regime persistence — gives fat tails and negative skew like the
    # real series without copying any real data.
    calm = rng.normal(0.95, 3.6, size=n_months)
    crisis = rng.normal(-1.5, 9.5, size=n_months)
    stay = rng.uniform(size=n_months)
    state = np.zeros(n_months, dtype=bool)
    for t in range(1, n_months):
        # ~15% stationary crisis occupancy (entry 3%, exit 17%)
        p_crisis = 0.83 if state[t - 1] else 0.03
        state[t] = stay[t] < p_crisis
    r = np.where(state, crisis, calm)
    return r.astype(np.float64)


def hostile_monthly_returns(n: int = 97, seed: int = 20260820) -> np.ndarray:
    """An ADVERSARIAL percent-returns table (VERDICT r4 item 4): heavy
    tails, clustered negative runs, and extreme single-month moves — a
    stress fixture far from the benign S&P-like series above, for
    flushing out latent table-shape assumptions (the reference
    hard-codes its 1127-row table into shared memory,
    src/simulations.cu:123).

    Properties (deterministic per (n, seed)):
      - Student-t(2.5) body scaled to ~7% monthly std: genuinely heavy
        tails (infinite kurtosis in the limit).
      - Sticky crash regime: clusters of consecutive deep-negative
        months (mean -12%).
      - Pinned extremes: one -85% month and one +120% month (growth
        stays strictly positive — every value > -100 — so the exact
        FFT law and log-space machinery remain defined).
      - Any ``n``: use n < 128 (below one lane tile) and n near the
        2^15-1 sampler bound to stress the sliced-rotation gather.
    """
    if n < 3:
        raise ValueError(f"hostile table needs n >= 3, got {n}")
    rng = np.random.default_rng(seed + 7919 * n)
    body = rng.standard_t(2.5, size=n) * 4.5 + 0.3
    crash = rng.normal(-12.0, 6.0, size=n)
    stay = rng.uniform(size=n)
    state = np.zeros(n, dtype=bool)
    for t in range(1, n):
        p_crash = 0.7 if state[t - 1] else 0.06
        state[t] = stay[t] < p_crash
    r = np.where(state, crash, body)
    # keep every month's growth strictly positive, then pin the extremes
    r = np.clip(r, -95.0, 150.0)
    r[n // 3] = -85.0
    r[(2 * n) // 3] = 120.0
    return r.astype(np.float64)


def write_hostile_csv(path: str, n: int = 97) -> None:
    """Vendor the hostile fixture in the reference CSV schema (leading
    NaN row, ``Date,returns`` header — get_data.py:58-69 format)."""
    r = hostile_monthly_returns(n)
    with open(path, "w") as f:
        f.write("Date,returns\n")
        y, m = 1900, 1
        f.write(f"{y:04d}-{m:02d},\n")  # leading NaN row
        for v in r:
            m += 1
            if m == 13:
                m, y = 1, y + 1
            f.write(f"{y:04d}-{m:02d},{v:.16g}\n")


def write_csv(path: str) -> None:
    r = synthetic_monthly_returns()
    dates = []
    y, m = 1928, 1
    for _ in range(N_MONTHS):  # first row carries the pct_change NaN
        dates.append(f"{y:04d}-{m:02d}")
        m += 1
        if m == 13:
            m, y = 1, y + 1
    with open(path, "w") as f:
        f.write("Date,returns\n")
        f.write(f"{dates[0]},\n")  # leading NaN row (empty field)
        for d, v in zip(dates[1:], r):
            f.write(f"{d},{v:.16g}\n")


if __name__ == "__main__":
    from stock_market_monte_carlo_torch.data.loader import (
        HOSTILE_CSV,
        SYNTHETIC_CSV,
    )

    write_csv(SYNTHETIC_CSV)
    write_hostile_csv(HOSTILE_CSV)
    print(f"wrote {SYNTHETIC_CSV} and {HOSTILE_CSV}")
