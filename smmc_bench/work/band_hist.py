"""``simulate_bands`` in hist mode past the draw, per path-month: the
compounding (1), a percent withdrawal's keep (1), and the month's cell:
fmax, log, multiply, add, floor, two clamps, convert, +1 and the count
(10). Bytes: a chunk's (T, n_bins + 2) counts, written once."""

from smmc_bench.work import chunks, path_months


def work(config, traffic):
    keep = 0 if traffic["strategy"]["kind"] == "none" else 1
    return dict(bytes=chunks(config) * 4.0 * config["n_periods"]
                * (traffic["call"]["n_bins"] + 2),
                scalar_ops=path_months(config) * (1 + keep + 10),
                tensor_flop=0.0)
