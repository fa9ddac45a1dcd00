"""The CLT Gaussian draw, per path: ceil(T / 128) blocks of 128 counter
words, each word shifted to its 16-bit count, converted and rounded to
bfloat16 (3); per path-block the product of its 128 counts with Q, 2 x
128 x 128 tensor-core flop; per path-month the affine step arow + z_raw
* cs (2). A block's tile key is shared by the tile's paths and not
counted; nor is anything of the kernel's design (its log-space prefix,
the quad's scan, Q's staging). The compounding and the withdrawal are
``stats_epilogue``'s."""

import math

from smmc_bench.work import WORD, path_months

K = 128


def work(config, traffic):
    blocks = math.ceil(config["n_periods"] / K)
    n = float(config["n_paths"])
    return dict(bytes=0.0,
                scalar_ops=n * blocks * K * (WORD + 3)
                + path_months(config) * 2,
                tensor_flop=n * blocks * 2.0 * K * K)
