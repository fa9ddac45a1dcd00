"""The terminal law's counter draw: V_T in one step from the fitted law of
the T-month bootstrap compound. Frozen copy of the counter branch of
``law_chunk_plain`` (``stock_market_monte_carlo_torch/ops/cuda_engine.py``,
commit 9db0996): a path's word is word 0 of its tile under the law's
stream base (the seed's base xor ``LAW_STREAM_XOR``), s = sqrt(2)
erfinv(2u - 1) / 6.25 in float32, and V_T = scale * exp(C(s)) with C the
Chebyshev series of ``law_fit.law_operand``, run by Clenshaw's recurrence
in float32 in the law kernel's order of operations.

``Run.months`` compounds month by month from f32(v0), and a draw is given
no horizon, so the one-step law is written as growth factors: month 0
takes G = f32(V_T) / f32(v0), every later month an exact 1.0. A float32
product with 1.0 is exact, so the finals are f32(f32(v0) * G), at most an
ulp from the law kernel's scale * exp(C(s)). The fit's T and v0 are the
model's ``law`` entry; the fit reads the raw returns from the table file
the model names, float32 and then float64, as the port is handed them, and
runs once a process for each table, T and v0. The law carries no
withdrawal: a mix that withdraws would be applied on top of it.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from smmc_bench import cells
from smmc_bench.reference import law_fit
from smmc_bench.reference.stream import f32, month_words, normal_z

# the law's stream family, apart from the month loop's
LAW_STREAM_XOR = 0x1A37
ROOT = Path(__file__).resolve().parents[3]


@functools.lru_cache(maxsize=4)
def operand(table: str, table_rows: int, n_periods: int,
            initial_capital: float) -> np.ndarray:
    """The (49,) float32 law operand of the model's table file over
    ``n_periods`` months from ``initial_capital``."""
    returns = cells.read_table(ROOT, {"model": {"table": table,
                                                "table_rows": table_rows}})
    return law_fit.law_operand(returns.astype(np.float64), n_periods,
                               initial_capital)


def finals(model, base, tile0, n_tiles, device):
    """(n_tiles, 64, 128) float32 V_T of those tiles' paths under stream
    ``base``, as the law kernel computes them."""
    law = model["law"]
    op = torch.as_tensor(operand(model["table"], int(model["table_rows"]),
                                 int(law["n_periods"]),
                                 float(law["initial_capital"])),
                         device=device)
    word = month_words(base ^ LAW_STREAM_XOR, tile0, n_tiles, device)(0)
    s = normal_z(word) * f32(1.0 / law_fit.LAW_ZMAX)
    two_s = 2.0 * s
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for k in range(law_fit.LAW_D - 1, 0, -1):
        b0 = two_s * b1 - b2 + op[1 + k]
        b2 = b1
        b1 = b0
    return op[0] * torch.exp(s * b1 - b2 + op[1])


def growth_fn(model, table, base, tile0, n_tiles, device):
    g = finals(model, base, tile0, n_tiles, device) / f32(
        model["law"]["initial_capital"])
    ones = torch.ones_like(g)
    return lambda t: g if t == 0 else ones
