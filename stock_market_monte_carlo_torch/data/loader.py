"""Historical monthly-returns loading (numpy only).

Same contract as ``stock_market_monte_carlo_tpu.data.loader``: read the
``returns`` column (percent) of a ``Date,returns`` CSV, skipping empty and
non-numeric rows, through the native C++ reader where its library is
built (``native/``), else in Python. The vendored tables (the synthetic
S&P 500 stand-in and the adversarial fixture) are the port's own copies,
in this directory, byte for byte the JAX package's.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Optional

import numpy as np

_DATA_DIR = os.path.dirname(os.path.abspath(__file__))
SYNTHETIC_CSV = os.path.join(_DATA_DIR, "sp500_monthly_returns_synthetic.csv")
# Adversarial fixture: heavy tails, n=97 (below one 128-lane row)
HOSTILE_CSV = os.path.join(_DATA_DIR, "hostile_monthly_returns.csv")
# The reference's hard-coded location (examples/benchmark_mc_cpu.cpp:25).
REFERENCE_CSV_RELPATH = os.path.join("data", "SP500_monthly_returns.csv")


def default_returns_path() -> str:
    """``$SMMC_RETURNS_CSV``, then ``./data/SP500_monthly_returns.csv``
    relative to the CWD, then the vendored synthetic table."""
    env = os.environ.get("SMMC_RETURNS_CSV")
    if env:
        return env
    if os.path.exists(REFERENCE_CSV_RELPATH):
        return REFERENCE_CSV_RELPATH
    return SYNTHETIC_CSV


def read_historical_returns(path: Optional[str] = None) -> np.ndarray:
    """The ``returns`` column of a monthly-returns CSV, float32."""
    from stock_market_monte_carlo_torch.native import native_read_returns

    if path is None:
        path = default_returns_path()
    try:
        out = native_read_returns(path)
    except IOError:
        # the Python reader below raises the precise error
        out = None
    if out is not None and len(out):
        return out
    values = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        try:
            col = header.index("returns")
        except ValueError:
            raise ValueError(
                f"CSV {path!r} has no 'returns' column (header={header!r})"
            ) from None
        for row in reader:
            if len(row) <= col:
                continue
            try:
                v = float(row[col])
            except ValueError:
                continue
            if math.isnan(v):
                continue
            values.append(v)
    if not values:
        raise ValueError(f"CSV {path!r} contains no parseable returns")
    return np.asarray(values, dtype=np.float32)
