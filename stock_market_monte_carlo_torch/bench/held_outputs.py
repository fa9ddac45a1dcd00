"""A bare launch keeps its outputs alive after its outputs closure is gone.

A launcher returns ``(launch, outputs)``; callers that time the kernel
keep ``launch`` and drop ``outputs`` (``bench/grids.py``,
``bench/chunk_times.py``, ``chip_smoke.py`` phase 6). The device tensors
the kernel writes must then be held by ``launch`` itself (its defaults):
otherwise the caching allocator hands their memory to the next allocation
and the kernel writes into it (ROADMAP queue 3, F4).

``check(name)`` launches one of ``CASES`` twice on the card: once keeping
its outputs closure, and once after dropping it and allocating a sentinel
tensor of each output's size. The second launch must leave the sentinels
as they were and give the same tensors as the first.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

SENTINEL = -7


def _band_args(kind, dev):
    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.engine import bands as bands_eng
    from stock_market_monte_carlo_torch.engine import engine as eng
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    model, none, t = smt.HistoricalBootstrap.from_csv(), smt.NoWithdrawal(), 12
    centers, scales = bands_eng.band_grid(model, none, t, 1000.0)
    if kind == "hist":
        ca, cb, _ = bands_eng.hist_coefficients(centers, scales, 64, 1000.0)
        reduce_kw = dict(n_bins=64, coef_a_host=ca)
    else:
        ca, cb, klo, khi, _, _ = bands_eng.cdf_coefficients(centers, scales,
                                                            16, 1000.0)
        reduce_kw = dict(kappa_lo=klo, kappa_hi=khi, n_thresholds=16,
                         coef_b_host=cb)
    table, draw = ce.draw_operands(model, dev)
    kw = dict(n_periods=t, seed_base=eng._segment_base(3, 0), tile0=0,
              valid=3 * 8192 + 5, n_paths=4 * 8192, v0=1000.0, **draw,
              **reduce_kw)
    return (table, None, torch.as_tensor(ca, device=dev),
            torch.as_tensor(cb, device=dev)), kw


def _cases():
    """name -> (launcher, builder of (args, kwargs) on a device)."""
    from stock_market_monte_carlo_torch.ops import bands as bk
    from stock_market_monte_carlo_torch.ops import byte_planes as bp
    from stock_market_monte_carlo_torch.ops import calibration as cal
    from stock_market_monte_carlo_torch.ops import histogram

    def rand(shape, dev, seed):
        return torch.as_tensor(np.random.default_rng(seed).lognormal(
            size=shape).astype(np.float32), device=dev)

    return {
        "bands_hist": (bk.month_hist_launcher,
                       lambda dev: _band_args("hist", dev)),
        "bands_cdf": (bk.month_cdf_launcher,
                      lambda dev: _band_args("cdf", dev)),
        "counts_below_tile": (bk.counts_below_tile_launcher, lambda dev: (
            (rand((64, 128), dev, 1), rand((32, 128), dev, 2)), {})),
        "grid_overhead": (cal.grid_overhead_launcher, lambda dev: (
            ("counter", 2), dict(seed=5, n_tiles=4, device=dev))),
        "calib": (cal.calib_launcher, lambda dev: (
            (16,), dict(n_periods=16, n_paths=8192, seed=5, device=dev))),
        "op_toy": (cal.op_toy_launcher, lambda dev: (
            ("mm",), dict(n_tiles=2, device=dev))),
        "histogram": (histogram.histogram_launcher, lambda dev: (
            (torch.randint(0, 4096, (1 << 16,), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3)
                           ).to(dev),), dict(hb=4096, mode="index"))),
        "flatten_tile": (histogram.flatten_tile_launcher, lambda dev: (
            (rand((4 * 64, 128), dev, 4),), {})),
        "byte_planes": (bp.byte_planes_launcher, lambda dev: (
            (bp.BYTES_SEEDS[:2],), dict(device=dev))),
    }


CASES = tuple(sorted(_cases()))


def _tensors(values):
    out = []
    for v in values:
        for x in (v if isinstance(v, tuple) else (v,)):
            if isinstance(x, torch.Tensor):
                out.append(x)
    return out


def _outputs(outputs):
    """The device tensors the outputs closure reads: the kernel's
    outputs."""
    return _tensors(c.cell_contents for c in outputs.__closure__ or ())


def check(name, device="cuda"):
    """(ok, detail) of the held-outputs check of launcher ``name``."""
    launcher, build = _cases()[name]
    args, kw = build(torch.device(device))
    launch, outputs = launcher(*args, **kw)
    launch()
    torch.cuda.synchronize()
    want = [x.clone() for x in _outputs(outputs)]
    del launch, outputs
    launch, outputs = launcher(*args, **kw)
    held = _tensors(launch.__defaults__ or ())
    where = [next((i for i, h in enumerate(held) if h is x), None)
             for x in _outputs(outputs)]
    sizes = [(x.shape, x.dtype) for x in _outputs(outputs)]
    del outputs, held
    gc.collect()
    # the allocations a freed output's memory would go to
    sentinels = [torch.full(shape, SENTINEL, dtype=dtype, device=device)
                 for shape, dtype in sizes]
    launch()
    torch.cuda.synchronize()
    held = _tensors(launch.__defaults__ or ())
    untouched = all(bool((s == SENTINEL).all()) for s in sentinels)
    all_held = bool(want) and None not in where
    equal = all_held and all(torch.equal(held[i], w)
                             for i, w in zip(where, want))
    return all_held and untouched and equal, dict(
        outputs=len(want), held_by_launch=all_held,
        sentinels_untouched=untouched, outputs_equal=equal)
