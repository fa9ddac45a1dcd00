"""The counter stream's Gaussian ICDF draw, growth a + b * z with z =
sqrt(2) erfinv(2u - 1) of the path-month's word: frozen copy of the
Gaussian branch of ``month_growth`` (``stock_market_monte_carlo_torch/
ops/cuda_engine.py``, commit b0a87fd)."""

from smmc_bench.reference.stream import gaussian_ab, month_words, normal_z


def growth_fn(model, table, base, tile0, n_tiles, device):
    a, b = gaussian_ab(model["args"]["mean_pct"], model["args"]["std_pct"])
    words = month_words(base, tile0, n_tiles, device)

    def growth(t):
        return a + b * normal_z(words(t))
    return growth
