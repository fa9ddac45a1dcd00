"""The comparison that decides ``correct``: gaps between a query's answer
and the plain reference's answer to the same query, each held to the
cell's limit (``limits/<workload>.json``).

- stats (``simulate_stats``): the relative gaps of the mean, the standard
  deviation, the least and the largest final value and the total
  withdrawn; the count below the target's gap over the paths; and the
  histogram's, the largest gap of its cumulative counts over the paths.
  Together they cover the draw and compounding of every path, the chunk
  epilogue (power sums, min and max, count below, withdrawn, bins) and
  the host's float64 merge.
- bands (``simulate_bands``): the per-month counts' gap, the largest over
  the months of the largest gap of the cumulative counts over the paths
  (the counts below thresholds are cumulative already), and the band
  values' largest relative gap over the levels and months.
"""

from __future__ import annotations

import numpy as np


def _rel(p: float, r: float) -> float:
    if p == r:
        return 0.0
    return abs(p - r) / max(abs(r), 1e-300)


def _cdf_gap(p, r, n: int, cumulative: bool) -> float:
    """Largest gap of the cumulative counts of rows ``p``, ``r`` (last
    axis), over ``n``."""
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    if p.shape != r.shape:
        return float("inf")
    if not cumulative:
        p, r = np.cumsum(p, axis=-1), np.cumsum(r, axis=-1)
    return float(np.max(np.abs(p - r))) / n


def gaps(kind: str, program: dict, reference: dict, n_paths: int,
         cdf_mode: bool = False) -> dict:
    """The compared numbers of one query, by name."""
    if kind == "stats":
        return dict(
            mean_gap=_rel(program["mean"], reference["mean"]),
            std_gap=_rel(program["std"], reference["std"]),
            min_gap=_rel(program["min"], reference["min"]),
            max_gap=_rel(program["max"], reference["max"]),
            below_gap=abs(program["count_below"] - reference["count_below"])
            / n_paths,
            withdrawn_gap=_rel(program["withdrawn"], reference["withdrawn"]),
            hist_gap=_cdf_gap(program["hist"], reference["hist"], n_paths,
                              False),
        )
    if kind == "bands":
        pv = np.asarray(program["values"], np.float64)
        rv = np.asarray(reference["values"], np.float64)
        if pv.shape != rv.shape:
            band = float("inf")
        else:
            diff = np.abs(pv - rv)
            band = float(np.max(np.where(
                diff == 0, 0.0, diff / np.maximum(np.abs(rv), 1e-300))))
        return dict(
            counts_gap=_cdf_gap(program["counts"], reference["counts"],
                                n_paths, cdf_mode),
            band_gap=band,
        )
    raise ValueError(f"unknown check {kind!r}")


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every limit's number at or
    under it; a NaN, or a limit without its number, fails."""
    rows = [(name, numbers.get(name, float("nan")), float(limit))
            for name, limit in limits.items()]
    ok = bool(rows) and all(v <= lim for _, v, lim in rows)
    return ok, rows
