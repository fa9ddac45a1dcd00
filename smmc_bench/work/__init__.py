"""Frozen operation and byte counts of the algorithms a query runs: one
module per algorithm, each ``work(config, traffic) -> dict(bytes,
scalar_ops, tensor_flop)`` for one query. A configuration names its draw
(``"work"``), a traffic mix the rest (``"work"``: a list); a query's work
is their sum.

The counts follow ``stock_market_monte_carlo_torch/bench/roofline.py``
at commit b0a87fd, corrected to the work that the stream contract and
the statistics need for these inputs, whatever kernel runs them: a libm
call (logf, expf, log1pf, sqrtf) counts as one operation, a word shared by
a tile's paths (its month key) once, and nothing of a kernel's design
(its tiles, its shuffles, its loads) counts. So the bounds err low.
"""

import math

# the counter stream: the finalizer (3 shifts, 3 xors, 2 multiplies); a
# word adds the position's multiply and add
HASH = 8
WORD = HASH + 2
# floor(n * u / 2^32) by its 16-bit split
IDX = 7
# u23 (4), 2u-1 (2), -log1p(-x*x) (4), the p polynomial (17), select and
# two scales (3); the q polynomial (sqrtf, -3, 16) only where w >= 5, i.e.
# |2u-1| >= sqrt(1 - e^-5)
NORMAL_Z = 30 + 18 * (1.0 - math.sqrt(1.0 - math.exp(-5.0)))


def path_months(config: dict) -> float:
    return float(config["n_paths"]) * float(config["n_periods"])


def chunks(config: dict) -> int:
    """Dispatches a query: the paths over the configuration's chunk."""
    return math.ceil(config["n_paths"]
                     / config["engine_options"]["chunk_paths"])


def tile_months(config: dict) -> float:
    return math.ceil(config["n_paths"] / 8192) * float(config["n_periods"])
