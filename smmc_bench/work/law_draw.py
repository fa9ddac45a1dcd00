"""The terminal law's draw, per path: the law stream's word, its normal
z = sqrt(2) erfinv(2u - 1) and the scale s = z / 6.25; the Clenshaw
recurrence over the D = 48 Chebyshev coefficients, 3 operations a step
(D - 1 steps); the finish s * b1 - b2 + c0, the exp and the scale (5).
No per-month term: the law draws V_T in one step. Bytes: the 49-float
operand, read once a chunk."""

from smmc_bench.reference.law_fit import LAW_D
from smmc_bench.work import NORMAL_Z, WORD, chunks


def work(config, traffic):
    per = WORD + NORMAL_Z + 2 + 3 * (LAW_D - 1) + 5
    return dict(bytes=chunks(config) * 4.0 * (LAW_D + 1),
                scalar_ops=float(config["n_paths"]) * per,
                tensor_flop=0.0)
