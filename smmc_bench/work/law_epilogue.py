"""``simulate_stats`` past the terminal law's draw: per path the epilogue,
the four power sums, min, max and the count below the target (16), the
log-spaced bin and its count (9); no path-month term, since the law
compounds nothing. Bytes: the histogram and the stats row, written once a
chunk."""

from smmc_bench.work import chunks


def work(config, traffic):
    cells = traffic["options"]["histogram_bins"] + 2
    return dict(bytes=chunks(config) * 4.0 * (cells + 9),
                scalar_ops=float(config["n_paths"]) * 25,
                tensor_flop=0.0)
