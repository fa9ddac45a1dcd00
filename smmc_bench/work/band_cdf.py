"""``simulate_bands`` in cdf mode past the draw, per path-month: the
compounding (1), a percent withdrawal's keep (1), and the count below the
month's K thresholds: the interior thresholds lie on an affine log grid,
so the histogram's cell arithmetic and count place the value (10), a
threshold load and a compare correct it, two compares place the guard
rows (4). Bytes: a chunk's (T, K + 1) counts, written once."""

from smmc_bench.work import chunks, path_months


def work(config, traffic):
    keep = 0 if traffic["strategy"]["kind"] == "none" else 1
    return dict(bytes=chunks(config) * 4.0 * config["n_periods"]
                * (traffic["call"]["n_thresholds"] + 1),
                scalar_ops=path_months(config) * (1 + keep + 14),
                tensor_flop=0.0)
