"""Reports of the histogram probes on the port's kernels: the counterparts
of ``experiments/exp_pallas_hist.py``, ``exp_rowhist.py`` and
``exp_flatten_cost.py``.

    python -m stock_market_monte_carlo_torch.bench.probes \\
        [--device cuda|cpu] [--n N]

``hist_report`` counts ``n`` (default 2^24) int32 indices drawn uniformly
from [0, 4096) through the histogram kernel's ``"index"`` mode (the two
TPU layouts' function), and ``n`` float32 values uniform in [0, 4096)
through its ``"clip_cast"`` mode (``exp_flatten_cost.py``'s in-kernel
histogram), and checks each count exact against ``np.bincount``. On the
card it adds ms per call on the card's clock (CUDA events around
back-to-back calls, ``headline.events_ms``): the kernel alone (the bare
launch), the counted wrapper, and ``torch.bincount`` of the indices as
``library_ms``. ``flatten_report`` flattens ``n / 8192`` (64,128) tiles of
``arange`` into one column and reports whether row-major order is kept,
with the kernel's ms on the card and ``Tensor.copy_``'s as ``library_ms``.

The experiments draw their inputs from ``jax.random.key(0)``; these draw
them from numpy's seed 0. The default device is the card, and without one
the reports fail; ``--device cpu`` runs the plain versions and reports no
times. Prints one JSON object: ``{"device": ..., "card": ..., "hist":
{...}, "flatten": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from stock_market_monte_carlo_torch.bench import headline
from stock_market_monte_carlo_torch.ops import histogram

CELLS = 4096
SEED = 0
N = 1 << 24


def inputs(n, dev):
    """(indices, floats) of ``n`` inputs on ``dev`` from numpy seed
    ``SEED``, and their host bins per mode."""
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, CELLS, n, dtype=np.int32)
    x = rng.uniform(0.0, 1.0, n).astype(np.float32) * np.float32(CELLS)
    return (torch.as_tensor(idx, device=dev), torch.as_tensor(x, device=dev),
            {"index": idx, "clip_cast": np.clip(x.astype(np.int32), 0,
                                                 CELLS - 1)})


def hist_report(n=N, device="cuda", k=headline.K, reps=headline.REPS):
    """Exactness of both modes against np.bincount; on the card, ms per
    ``n`` inputs of the kernel, the wrapper and ``torch.bincount``."""
    dev = (headline._require_card() if device == "cuda"
           else torch.device(device))
    idx, x, bins = inputs(n, dev)
    out = {"n": n, "cells": CELLS, "seed": SEED}
    for mode, data in (("index", idx), ("clip_cast", x)):
        got = histogram.histogram_counts(data, CELLS, mode=mode)
        got = got.cpu().numpy()
        out[f"{mode}_exact_vs_bincount"] = bool(np.array_equal(
            got, np.bincount(bins[mode], minlength=CELLS)))
        out[f"{mode}_mass"] = int(got.sum())
        if dev.type != "cuda":
            continue
        launch, _ = histogram.histogram_launcher(data, CELLS, mode=mode)
        out[f"{mode}_ms"] = headline.events_ms(lambda i: launch(), k, reps)
        out[f"{mode}_wrapper_ms"] = headline.events_ms(
            lambda i, d=data, m=mode: histogram.histogram_counts(
                d, CELLS, mode=m), k, reps)
    if dev.type == "cuda":
        out["library_ms"] = headline.events_ms(
            lambda i: histogram.library_counts(idx, CELLS), k, reps)
    return out


def flatten_report(n_tiles=N // histogram.TILE, device="cuda",
                   k=headline.K, reps=headline.REPS):
    """Whether ``flatten_tile`` keeps row-major order over ``n_tiles``
    tiles of arange; on the card, its ms and ``copy_``'s."""
    dev = (headline._require_card() if device == "cuda"
           else torch.device(device))
    n = n_tiles * histogram.TILE
    x = torch.arange(n, dtype=torch.float32, device=dev).reshape(-1, 128)
    got = histogram.flatten_tile(x)
    want = torch.arange(n, dtype=torch.float32, device=dev)
    out = {"n_tiles": n_tiles, "shape": list(got.shape),
           "row_major_order_kept": bool(torch.equal(got[:, 0], want))}
    if dev.type == "cuda":
        launch, _ = histogram.flatten_tile_launcher(x)
        out["ms"] = headline.events_ms(lambda i: launch(), k, reps)
        dst = torch.empty_like(got)
        out["library_ms"] = headline.events_ms(
            lambda i: dst.copy_(x.view(-1, 1)), k, reps)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m stock_market_monte_carlo_torch.bench.probes",
        description="The histogram probes' reports (one JSON line).")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--n", type=int, default=N,
                   help="inputs of each histogram, a multiple of 8192")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.n <= 0 or args.n % histogram.TILE:
        raise SystemExit(f"--n must be a positive multiple of "
                         f"{histogram.TILE}")
    record = {
        "device": args.device,
        "card": headline.card_line() if args.device == "cuda" else None,
        "hist": hist_report(args.n, args.device),
        "flatten": flatten_report(args.n // histogram.TILE, args.device),
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
