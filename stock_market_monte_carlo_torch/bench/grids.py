"""The historical month loop (``csrc/month_loop.cu``), the CLT kernel
(``csrc/clt.cu``) and the terminal law (``csrc/terminal_law.cu``) under
several grids, timed in turns on one CUDA card: the blocks a SM that cap
each launcher's grid (``blocks_per_sm`` of
``cuda_engine.month_loop_launcher``, ``clt.clt_launcher`` and
``cuda_engine.law_launcher``; the blocks stride over the chunk).

    python3 -m stock_market_monte_carlo_torch.bench.grids [NAME ...]

One 2^24-path chunk at 360 months with ``chip_smoke.py``'s phase-6
operands (its ``month_chunk_args``, ``clt_chunk_args`` and
``law_chunk_args``: seed 0, target 2000, 4096 histogram cells, no
withdrawal; the CLT also under the keep fold and the prefix, at a fixed
0.4 % a month). Each kernel runs its
settings in order, then in reverse; each arm is the median of 3
measurements of CUDA events around 5 bare launches
(``headline.events_ms``). Prints the card's name and power limit, then one
JSON line: per case, per setting, the grid's blocks and its two times (ms
a chunk). NAME picks cases (default: all). Imports neither jax nor the
JAX package.
"""

from __future__ import annotations

import json
import sys

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.bench import headline
from stock_market_monte_carlo_torch.ops import clt
from stock_market_monte_carlo_torch.ops import cuda_engine as ce

MONTHS = 360
CHUNK = 1 << 24
TARGET = 2000.0
MONTH_LOOP_BLOCKS = (4, 8, 16)
CLT_BLOCKS = (2, 3, 4)
LAW_BLOCKS = (4, 8, 16, 32)


def cases():
    """{name: (launcher, ops, kw, settings)}."""
    import chip_smoke as cs  # the checkout's root script

    none = smt.NoWithdrawal()
    ops, kw = cs.month_chunk_args(smt.HistoricalBootstrap.from_csv(), none,
                                  MONTHS, CHUNK, CHUNK, TARGET, seed=0)
    out = {"month_loop": (ce.month_loop_launcher, ops, kw,
                          MONTH_LOOP_BLOCKS)}
    for variant, strategy in (("plain", none),
                              ("keep_fold", smt.FixedPercentWithdrawal(0.4)),
                              ("prefix", smt.FixedPercentWithdrawal(0.4))):
        ops, kw = cs.clt_chunk_args(variant, strategy, MONTHS, CHUNK, CHUNK,
                                    TARGET, seed=0)
        out["clt" if variant == "plain" else f"clt_{variant}"] = (
            clt.clt_launcher, ops, kw, CLT_BLOCKS)
    ops, kw = cs.law_chunk_args(smt.HistoricalBootstrap.from_csv(), MONTHS,
                                CHUNK, CHUNK, TARGET, seed=0,
                                keep_finals=False)
    out["law"] = (ce.law_launcher, ops, kw, LAW_BLOCKS)
    return out


def main(argv=None):
    names = sys.argv[1:] if argv is None else argv
    sms = ce._sm_count(headline._require_card())
    print(headline.card_line(), flush=True)
    out = {}
    for name, (launcher, ops, kw, settings) in cases().items():
        if names and name not in names:
            continue
        kw = dict(kw, keep_finals=False)
        launches = {}
        for bps in settings:
            launch, _ = launcher(*ops, **kw, blocks_per_sm=bps)
            launches[bps] = launch
        order = [*settings, *reversed(settings)]
        times = {bps: [] for bps in settings}
        for bps in order:
            times[bps].append(headline.events_ms(
                lambda _, f=launches[bps]: f(), k=5, reps=3))
        out[name] = {str(bps): dict(
            blocks=ce._launch_geometry(sms, CHUNK, _rows(name), bps),
            ms=times[bps]) for bps in settings}
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out))


def _rows(name):
    """Paths a block takes at a time: the month loop's 8 warps of
    256-path items, the CLT's 64-path groups, the law's units."""
    return {"month_loop": ce._BLOCK * ce.HISTORICAL_LANE_PATHS,
            "law": ce.LAW_UNIT_PATHS}.get(name, clt._ROWS)


if __name__ == "__main__":
    main()
