"""The Sobol draws' month-loop kernel (``csrc/run_loop.cu``) under two
grids, timed in turns on one CUDA card: the launcher's (at most 8 blocks a
SM, as the other month-loop draws) and a persistent grid (as many blocks
as are resident at once, ``run_kernel_info``), each block looping over
its groups of 256 x K paths.

    python3 -m stock_market_monte_carlo_torch.bench.sobol_grid

One 2^24-path chunk of each Sobol draw at 360 months (32-bit positions),
at 360 and 1866 months at 64-bit positions (index_offset 2^33 + 777), with
the operands ``simulate_stats`` builds for seed 7, target 2000 and 4096
histogram cells. Each case runs 8 a SM, persistent, persistent, 8 a SM;
each arm is the median of 3 measurements of CUDA events around 5 bare
launches (``headline.events_ms``). Prints the card's name and power limit,
then one JSON line: per case, both grids' blocks and the four times (ms a
chunk). Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
from unittest import mock

import torch

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.bench import headline
from stock_market_monte_carlo_torch.engine import engine as eng
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_torch.ops import sobol

CHUNK = 1 << 24
DEEP_OFFSET = (1 << 33) + 777
LONG_MONTHS = 1866


def _chunk(model, n_periods, dev):
    """(table, keep), keywords of the first 2^24-path chunk of
    ``simulate_stats(model, ...)`` without a withdrawal."""
    none = smt.NoWithdrawal()
    spec = eng.make_histogram_spec(model, none, n_periods, headline.V0,
                                   smt.EngineOptions().histogram_bins)
    shift = sobol.digital_shift(eng._scramble_key(headline.SEED, dev),
                                n_periods)
    table, draw = ce.draw_operands(model, dev, n_periods, shift)
    kw = dict(strategy="none", amount=0.0, n_periods=n_periods,
              seed_base=eng._segment_base(headline.SEED, 0), tile0=0,
              valid=CHUNK, n_paths=CHUNK, v0=headline.V0,
              target=headline.TARGET,
              shift=eng.analytic_moment_shift(model, none, n_periods),
              lo=spec.lo, log_lo=spec.log_lo, inv_w=1.0 / spec.width,
              hb=spec.n_bins + 2, with_hist=True, keep_finals=False, **draw)
    keep = torch.ones((n_periods,), dtype=torch.float32, device=dev)
    return (table, keep), kw


def _launcher(ops, kw, persistent):
    """The bare launch and its grid's blocks: the launcher's grid, or the
    resident blocks a SM in its place."""
    geometry = ce._launch_geometry
    grids = []

    def patched(sms, valid, rows_per_block, blocks_per_sm):
        if persistent:
            blocks_per_sm = ce.run_kernel_info(
                kw["draw"], kw["strategy"], n_table=kw["n_table"],
                dir_cols=kw["direction"].shape[1],
                n_periods=kw["n_periods"], hb=kw["hb"],
                with_hist=kw["with_hist"])["blocks_per_sm"]
        grids.append(geometry(sms, valid, rows_per_block, blocks_per_sm))
        return grids[-1]

    with mock.patch.object(ce, "_launch_geometry", patched):
        launch, _ = ce.month_loop_launcher(*ops, **kw)
    return launch, grids[0]


def main():
    dev = headline._require_card()
    print(headline.card_line(), flush=True)
    hist = smt.HistoricalBootstrap.from_csv()
    cases = {}
    for months, offset in ((360, 0), (360, DEEP_OFFSET),
                           (LONG_MONTHS, DEEP_OFFSET)):
        for name, model in (
                ("sobol_gaussian", smt.SobolGaussianReturns.create(
                    months, index_offset=offset)),
                ("sobol_historical", smt.SobolHistoricalBootstrap.create(
                    hist.returns_pct, months, index_offset=offset))):
            ops, kw = _chunk(model, months, dev)
            own, own_blocks = _launcher(ops, kw, False)
            other, other_blocks = _launcher(ops, kw, True)
            turns = [headline.events_ms(lambda _, f=f: f(), k=5, reps=3)
                     for f in (own, other, other, own)]
            key = f"{name} {months} months index_offset={offset}"
            cases[key] = dict(blocks_8_a_sm=own_blocks,
                              persistent_blocks=other_blocks,
                              ms_8_a_sm=[turns[0], turns[3]],
                              ms_persistent=[turns[1], turns[2]])
            print(key, json.dumps(cases[key]), flush=True)
    print(json.dumps(cases))


if __name__ == "__main__":
    main()
