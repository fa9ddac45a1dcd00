"""The counter stream's Gaussian ICDF draw, per path-month: the word, z
= sqrt(2) erfinv(2u - 1) and the growth a + b z; per tile-month the
month key's word."""

from smmc_bench.work import NORMAL_Z, WORD, path_months, tile_months


def work(config, traffic):
    return dict(bytes=0.0,
                scalar_ops=path_months(config) * (WORD + NORMAL_Z + 2)
                + tile_months(config) * WORD,
                tensor_flop=0.0)
