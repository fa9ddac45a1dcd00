"""CSV outputs in the reference's schema.

Counterpart of ``stock_market_monte_carlo_tpu/utils/io.py``, byte for byte
its text. ``write_data_file`` writes the two-row layout of the reference's
helpers: a ``Returns,,`` row (the returns have one entry fewer than the
values, so the reference pads a blank cell) and a ``Values,`` row, every
cell comma-terminated, into ``./outputs/``.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np


def _fmt(x: float) -> str:
    # std::ofstream << float: 6 significant digits
    return f"{float(x):g}"


def print_vector(v: Sequence[float]) -> None:
    """The reference's ``print_vector``."""
    body = " ".join(f"{float(x):6.3f}" for x in v)
    print(f"v = [ {body}  ]")


def write_vector_file(fname: str, v: Iterable[float]) -> None:
    """The reference's ``write_vector_file``: flat comma-terminated values,
    no header, no directory handling."""
    with open(fname, "w") as f:
        for x in v:
            f.write(f"{_fmt(x)},")


def write_data_file(fname: str, returns: Sequence[float],
                    values: Sequence[float], out_dir: str = "./outputs/",
                    verbose: bool = True) -> str:
    """Write one simulation's returns and values CSV into ``out_dir``;
    return the path written. The native C++ writer goes first (bulk runs
    write thousands of files), Python when the library is not built."""
    from stock_market_monte_carlo_torch.native import native_write_data_file

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, fname)
    if verbose:
        print(f"Writing data to csv file {path}")
    if native_write_data_file(path, np.asarray(returns, np.float32),
                              np.asarray(values, np.float32)):
        return path
    with open(path, "w") as f:
        f.write("Returns,,")
        for x in returns:
            f.write(f"{_fmt(x)},")
        f.write("\nValues,")
        for x in values:
            f.write(f"{_fmt(x)},")
    return path


def read_data_file(path: str):
    """(returns, values) float32 arrays of a ``Returns,,/Values,`` CSV: the
    inverse of ``write_data_file``."""
    returns, values = [], []
    with open(path) as f:
        for line in f:
            cells = line.strip().split(",")
            tag = cells[0]
            nums = [float(c) for c in cells[1:] if c not in ("", "\n")]
            if tag == "Returns":
                returns = nums
            elif tag == "Values":
                values = nums
    return (np.asarray(returns, np.float32), np.asarray(values, np.float32))
