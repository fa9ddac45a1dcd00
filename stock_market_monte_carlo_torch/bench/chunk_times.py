"""CUDA-event times of the main paths' chunk kernels, for comparing two
checkouts of the port in turns on one card: run it from each checkout's
root in one call (parent, change, change, parent), with this file copied
into the other checkout where it lacks it.

    python3 -m stock_market_monte_carlo_torch.bench.chunk_times [NAME ...]

Each case is one 2^24-path chunk at 360 months with the operands that
``chip_smoke.py`` builds for its phase-6 timings (its ``*_chunk_args``,
seed 0, target 2000, 4096 histogram cells, no withdrawal unless the name
says so; the terminal law without and with finals; the XLA backend's
threefry loop, ``threefry_<draw>``, the Sobol Gaussian draw also under
0.4 % a month, ``threefry_sobol_gaussian_keep``, and terminal law,
``law_threefry``),
or the headline's
and the probes' shapes for the histogram kernel (2^24 indices over 4096
cells), the tile flatten (2048 tiles), the calibration kernels, the
byte planes of both experiments, the counts below a tile (K=32) and the
op-class toys (``op_toy_<op>``, 4096 tiles), launched bare (the
launcher's C call, uncounted): the median of 3 measurements of CUDA
events around 5 launches (``headline.events_ms``). Cases whose name ends
in ``_graph`` are timed with no host dispatch in them, as launches in one
CUDA graph (``headline.graph_ms``): the counts below a tile, and its
floor, a 1-element ``Tensor.fill_`` (``fill_one_graph``).
NAME picks cases (default: all). Prints the card's name and power limit,
then one JSON line {name: ms a chunk}. Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.bench import headline, probes
from stock_market_monte_carlo_torch.ops import bands as bk
from stock_market_monte_carlo_torch.ops import byte_planes as bp
from stock_market_monte_carlo_torch.ops import calibration as cal
from stock_market_monte_carlo_torch.ops import clt
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_torch.ops import histogram

MONTHS = 360
CHUNK = 1 << 24
TARGET = 2000.0


def cases():
    """{name: (launcher, ops, kw)} of every timed chunk."""
    import chip_smoke as cs  # the checkout's root script

    hist = smt.HistoricalBootstrap.from_csv()
    gauss = smt.GaussianReturns()
    deep = (1 << 33) + 777
    none = smt.NoWithdrawal()
    out = {}
    month_models = {
        "month_loop": hist,
        "month_loop_gaussian": gauss,
        "month_loop_reference": smt.HistoricalBootstrap(hist.returns_pct,
                                                        rng="reference"),
        "month_loop_sobol_gaussian": smt.SobolGaussianReturns.create(MONTHS),
        "month_loop_sobol_historical": smt.SobolHistoricalBootstrap.create(
            hist.returns_pct, MONTHS),
        "month_loop_sobol_gaussian_deep": smt.SobolGaussianReturns.create(
            MONTHS, index_offset=deep),
        "month_loop_sobol_historical_deep":
            smt.SobolHistoricalBootstrap.create(hist.returns_pct, MONTHS,
                                                index_offset=deep),
    }
    for name, model in month_models.items():
        out[name] = (ce.month_loop_launcher, *cs.month_chunk_args(
            model, none, MONTHS, CHUNK, CHUNK, TARGET, seed=0))
    out["month_loop_keep"] = (
        ce.month_loop_launcher, *cs.month_chunk_args(
            hist, smt.FixedPercentWithdrawal(0.4), MONTHS, CHUNK, CHUNK,
            TARGET, seed=0))
    out["month_loop_gaussian_keep"] = (
        ce.month_loop_launcher, *cs.month_chunk_args(
            gauss, smt.FixedPercentWithdrawal(0.4), MONTHS, CHUNK, CHUNK,
            TARGET, seed=0))
    for name, keep_finals in (("law", False), ("law_with_finals", True)):
        out[name] = (ce.law_launcher, *cs.law_chunk_args(
            hist, MONTHS, CHUNK, CHUNK, TARGET, seed=0,
            keep_finals=keep_finals))
    for name, model in (("threefry_historical", hist),
                        ("threefry_gaussian", gauss),
                        ("threefry_sobol_gaussian",
                         smt.SobolGaussianReturns.create(MONTHS))):
        out[name] = (ce.threefry_loop_launcher, *cs.threefry_chunk_args(
            model, none, MONTHS, CHUNK, CHUNK, TARGET, seed=0))
    out["threefry_sobol_gaussian_keep"] = (
        ce.threefry_loop_launcher, *cs.threefry_chunk_args(
            smt.SobolGaussianReturns.create(MONTHS),
            smt.FixedPercentWithdrawal(0.4), MONTHS, CHUNK, CHUNK, TARGET,
            seed=0))
    out["law_threefry"] = (ce.law_launcher, *cs.law_chunk_args(
        hist, MONTHS, CHUNK, CHUNK, TARGET, seed=0, keep_finals=False,
        draw="threefry"))
    for variant, strategy in (("plain", none),
                              ("keep_fold", smt.FixedPercentWithdrawal(0.4)),
                              ("prefix", smt.VariablePercentWithdrawal(
                                  np.full(MONTHS, 0.4, np.float32)))):
        key = "clt" if variant == "plain" else f"clt_{variant}"
        out[key] = (clt.clt_launcher, *cs.clt_chunk_args(
            variant, strategy, MONTHS, CHUNK, CHUNK, TARGET, seed=0))
    for key, model, kind, launcher in (
            ("bands_hist", hist, "hist", bk.month_hist_launcher),
            ("bands_hist_gaussian", gauss, "hist", bk.month_hist_launcher),
            ("bands_cdf", gauss, "cdf", bk.month_cdf_launcher),
            ("bands_cdf_historical", hist, "cdf", bk.month_cdf_launcher)):
        out[key] = (launcher, *cs.band_chunk_args(model, none, kind, MONTHS,
                                                  CHUNK, CHUNK, seed=0))
    dev = cs.DEVICE
    idx, _, _ = probes.inputs(CHUNK, dev)
    tiles = torch.arange(CHUNK, dtype=torch.float32, device=dev).reshape(
        -1, 128)
    out["histogram_index"] = (histogram.histogram_launcher, (idx,),
                              dict(hb=probes.CELLS, mode="index"))
    out["flatten_tile"] = (histogram.flatten_tile_launcher, (tiles,), {})
    for n_ops in cal.CALIB_OPS:
        out[f"calib_{n_ops}"] = (cal.calib_launcher, (n_ops,), dict(
            n_periods=MONTHS, n_paths=CHUNK, seed=cs.CALIB_SEED, device=dev))
    out["grid_overhead"] = (cal.grid_overhead_launcher, ("const", 16), dict(
        seed=cs.GRID_SEED, n_tiles=CHUNK // ce.TILE_PATHS, device=dev))
    out["byte_planes"] = (bp.byte_planes_launcher, (bp.BYTES_SEEDS,),
                          dict(device=dev))
    out["byte_planes_crossword"] = (bp.byte_planes_launcher,
                                    (bp.CROSSWORD_SEEDS,), dict(device=dev))
    rng = np.random.default_rng(0)
    out["counts_below_tile"] = (bk.counts_below_tile_launcher, tuple(
        torch.as_tensor(rng.lognormal(size=shape).astype(np.float32),
                        device=dev) for shape in ((64, 128), (32, 128))), {})
    out["counts_below_tile_graph"] = out["counts_below_tile"]
    out["fill_one_graph"] = (fill_one_launcher, (dev,), {})
    for op in cal.TOY_OPS:
        out[f"op_toy_{op}"] = (cal.op_toy_launcher, (op,), dict(
            n_tiles=cal.TOY_TILES, device=dev))
    return out


def fill_one_launcher(device):
    """``(launch, outputs)`` of a 1-element ``Tensor.fill_``: the floor
    of a launch under graph replay."""
    t = torch.empty(1, device=device)
    return (lambda: t.fill_(1.0)), lambda: t


def main(argv=None):
    names = sys.argv[1:] if argv is None else argv
    headline._require_card()
    print(headline.card_line(), flush=True)
    times = {}
    for name, (launcher, ops, kw) in cases().items():
        if names and name not in names:
            continue
        if "keep_finals" in kw and not name.startswith("law"):
            kw = dict(kw, keep_finals=False)
        if name.endswith("_graph"):
            times[name] = headline.graph_ms(lambda: launcher(*ops, **kw))
            continue
        launch, _ = launcher(*ops, **kw)
        times[name] = headline.events_ms(lambda _: launch(), k=5, reps=3)
    print(json.dumps(times))


if __name__ == "__main__":
    main()
