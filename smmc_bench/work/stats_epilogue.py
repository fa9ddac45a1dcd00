"""``simulate_stats`` past the draw: per path-month the compounding (1)
and a percent withdrawal's keep, its withdrawn term and its sum (3); per
path the epilogue: the four power sums, min, max, the count below the
target, the withdrawn total (16), the log-spaced bin and its count (9).
Bytes: the histogram and the stats row, written once a chunk."""

from smmc_bench.work import chunks, path_months


def work(config, traffic):
    strat = 0 if traffic["strategy"]["kind"] == "none" else 3
    cells = traffic["options"]["histogram_bins"] + 2
    return dict(bytes=chunks(config) * 4.0 * (cells + 9),
                scalar_ops=path_months(config) * (1 + strat)
                + float(config["n_paths"]) * 25,
                tensor_flop=0.0)
