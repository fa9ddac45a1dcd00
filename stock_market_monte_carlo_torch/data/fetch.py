"""Yahoo Finance data fetcher (network-gated; the port's copy of
``stock_market_monte_carlo_tpu/data/fetch.py``, pandas only).

Port of python/get_data.py:11-72: download ^GSPC 1928-01-01..2022-01-01,
monthly-mean resample of the adjusted close, percent change -> CSV with
``Date,returns`` (leading NaN row), plus overview plots. Requires the
optional ``yfinance``/``pandas`` packages and network access; environments
without them (like CI) use the vendored synthetic snapshot instead.
"""

from __future__ import annotations

import os


def monthly_returns_from_daily(data):
    """(df_daily, df_monthly, monthly_returns) from a yfinance-shaped
    daily frame.

    The parsing/transform half of the fetch (ref: get_data.py:33-68),
    separated so it can be tested against RECORDED response shapes
    without network: handles modern yfinance's ticker-level MultiIndex
    columns (which would otherwise grow a second CSV header row and break
    the ``Date,returns`` schema), prefers 'Adj Close' with a 'Close'
    fallback, monthly-mean resamples, and emits percent changes with a
    leading NaN row and a monthly PeriodIndex named Date.
    """
    import pandas as pd

    if isinstance(data.columns, pd.MultiIndex):
        data = data.copy()
        data.columns = data.columns.get_level_values(0)
    col = "Adj Close" if "Adj Close" in data else "Close"
    df_monthly = data[[col]].resample("1ME").mean()

    monthly_returns = 100 * df_monthly.pct_change()
    monthly_returns = monthly_returns.rename(columns={col: "returns"})
    monthly_returns.columns = ["returns"]  # belt and braces vs MultiIndex
    monthly_returns.index = monthly_returns.index.to_period("M")
    monthly_returns.index.name = "Date"
    return data[[col]], df_monthly, monthly_returns


def fetch_sp500(out_csv: str = "data/SP500_monthly_returns.csv",
                start: str = "1928-01-01", end: str = "2022-01-01",
                plot: bool = True) -> str:
    try:
        import yfinance as yf
    except ImportError as e:
        raise SystemExit(
            "yfinance is not installed in this environment; "
            "use the vendored synthetic returns CSV "
            "(stock_market_monte_carlo_torch/data/"
            "sp500_monthly_returns_synthetic.csv) or install yfinance "
            "on a machine with network access."
        ) from e

    print("- Downloading S&P500 data from Yahoo finance...")
    # auto_adjust=False keeps the reference's 'Adj Close' column
    data = yf.download("^GSPC", start, end, auto_adjust=False)

    print("- Generating CSV file with monthly returns...")
    df_daily, df_monthly, monthly_returns = monthly_returns_from_daily(data)

    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    monthly_returns.to_csv(out_csv)
    print(f"- Saved CSV of monthly historical returns to {out_csv!r}")

    if plot:
        _overview_plots(df_daily, df_monthly, monthly_returns,
                        os.path.dirname(out_csv) or ".")
    print("Done!")
    return out_csv


def _overview_plots(df_daily, df_monthly, monthly_returns, out_dir):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(16, 10))
    df_daily.plot(logy=True, ax=ax, label="daily")
    df_monthly.plot(logy=True, ax=ax, label="monthly")
    plt.title("Daily and Monthly value of S&P500")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, "SP500_accumulated_returns.png"))

    fig, ax = plt.subplots(figsize=(16, 10))
    monthly_returns.plot(ax=ax)
    plt.title("Monthly returns of S&P500")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, "SP500_monthly_returns.png"))
    plt.close("all")
    print(f"Saved overview plots to {out_dir!r}")
