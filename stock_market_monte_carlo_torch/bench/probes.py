"""Reports of the experiment probes on the port's kernels: the
counterparts of ``experiments/exp_pallas_hist.py``, ``exp_rowhist.py`` and
``exp_flatten_cost.py`` (the histogram probes), ``exp_clt_roofline.py``
(the CLT's op-class toys), ``exp_clt_ablate.py`` (its ablation),
``exp_clt_ts2.py`` (its tile grouping), ``exp_prng_bytes.py`` and
``exp_prng_crossword.py`` (the counter stream's byte planes).

    python -m stock_market_monte_carlo_torch.bench.probes \\
        [--device cuda|cpu] [--n N]
        [--only hist|flatten|toys|ablation|grouping|bytes|crossword ...]

Without ``--only`` every report runs. ``hist_report`` counts ``n``
(default 2^24) int32 indices drawn uniformly from [0, 4096) through the
histogram kernel's ``"index"`` mode (the two TPU layouts' function), and
``n`` float32 values uniform in [0, 4096) through its ``"clip_cast"`` mode
(``exp_flatten_cost.py``'s in-kernel histogram), and checks each count
exact against ``np.bincount``. On the card it adds ms per call on the
card's clock (CUDA events around back-to-back calls,
``headline.events_ms``): the kernel alone (the bare launch), the counted
wrapper, and ``torch.bincount`` of the indices as ``library_ms``.
``flatten_report`` flattens ``n / 8192`` (64,128) tiles of ``arange`` into
one column and reports whether row-major order is kept, with the kernel's
ms on the card and ``Tensor.copy_``'s as ``library_ms``.

``clt_toys_report`` runs the seven toy classes over the experiment's 4096
tiles and prints, on the card, each class's ms a 2^24-path chunk
equivalent and T elem/s, the per-pass costs and the modelled 3-block chain
floor by ``exp_clt_roofline.py``'s formula, the production CLT's ms a chunk
beside it, and the cost of the counter stream's hash, which the port's
chain adds to the TPU's (from the hash toy's SASS instructions a word and
the int32 rate of the same run). ``clt_ablation_report`` and
``clt_grouping_report`` run the CLT's probe instances over ``n`` paths x
360 months with the experiments' inputs: ms per chunk of base and each
ablation and its delta against base; ms at 0, 1, 2 and 4 tiles a block,
whether finals, histogram, counts, min and max equal those at 0, and the
power sums' largest relative difference. ``byte_planes_report`` and
``crossword_report`` dump the counter stream's byte planes at the
experiments' seeds and print their host statistics.

The histogram experiments draw their inputs from ``jax.random.key(0)``;
these draw them from numpy's seed 0. The default device is the card, and
without one the reports fail; ``--device cpu`` runs the plain versions and
reports no times. Prints one JSON object: ``{"device": ..., "card": ...,
"<report>": {...}, ...}``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from stock_market_monte_carlo_torch.bench import headline
from stock_market_monte_carlo_torch.ops import byte_planes as bp
from stock_market_monte_carlo_torch.ops import calibration as cal
from stock_market_monte_carlo_torch.ops import clt
from stock_market_monte_carlo_torch.ops import histogram

CELLS = 4096
SEED = 0
N = 1 << 24
# the CLT experiments' horizon, seeds (iscal[0]) and scalars (fscal)
CLT_MONTHS = 360
ABLATE_SEED, GROUPING_SEED = 99, 77
CLT_A, CLT_B, CLT_TARGET, CLT_V0 = 1.005, 1.0 / 120.0, 2000.0, 1000.0


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


def _device(device):
    return (headline._require_card() if device == "cuda"
            else torch.device(device))


def clt_toys_report(n_tiles=cal.TOY_TILES, device="cuda", k=headline.K,
                    reps=headline.REPS):
    """``exp_clt_roofline.main``: per class, the rows' checksum; on the
    card its ms over ``n_tiles`` tiles, ms a pass and T elem/s, the derived
    per-pass costs (exp_clt_roofline.py:143-152, unchanged), the modelled
    chain floor, the production CLT's ms a 2^24 x 360 chunk, and the hash's
    cost a chunk at the int32 rate measured here."""
    dev = _device(device)
    elems = n_tiles * cal.TOY_ROWS * 128
    classes = {}
    for op in cal.TOY_OPS:
        rows = cal.op_toy_chunk(op, n_tiles, dev)
        entry = {"checksum": float(rows.double().sum())}
        if dev.type == "cuda":
            launch, _ = cal.op_toy_launcher(op, n_tiles, dev)
            ms = headline.events_ms(lambda i, launch=launch: launch(), k,
                                    reps)
            entry.update(ms=ms, ms_per_pass=ms / cal.TOY_PASSES,
                         t_elem_per_s=elems * cal.TOY_PASSES / ms / 1e9)
        classes[op] = entry
    out = {"n_tiles": n_tiles, "passes": cal.TOY_PASSES, "classes": classes}
    if dev.type != "cuda":
        return out
    # the experiment's derived single-op costs (ms a pass) and chain floor
    t = {op: classes[op]["ms"] / cal.TOY_PASSES for op in cal.TOY_OPS}
    shift1 = max(t["shf"] - t["iadd"], 0.0)
    cvt1 = max(t["cvt"] - t["iadd"] - t["mul"], 0.0)
    per_block = shift1 + cvt1 + t["mm"] + t["mul"]
    case = headline.chunk_cases(CLT_MONTHS, device=dev)["clt"]
    launch, _ = clt.clt_launcher(*case[2], **dict(case[3], tile0=0))
    clt_ms = headline.events_ms(lambda i: launch(), k, reps)
    sass = cal.op_toy_sass()
    rate = headline.calib_report(k=k, reps=reps)["int_op_rate_per_s"]
    words = headline.CHUNK * 3 * clt.CLT_K
    per_word = sass["hash"]["per_element_pass"]
    out.update(
        derived_ms_per_pass=dict(mul=t["mul"], fma=t["fma"], iadd=t["iadd"],
                                 shift=shift1, cvt=cvt1, mm_affine=t["mm"],
                                 hash=t["hash"]),
        chain_floor_ms=3 * per_block,
        clt_ms_per_chunk=clt_ms,
        chain_floor_over_clt=3 * per_block / clt_ms,
        sass_per_element_pass={op: v["per_element_pass"]
                               for op, v in sass.items()},
        sass_opcodes={op: v["opcodes"] for op, v in sass.items()},
        int_op_rate_per_s=rate,
        hash_words_per_chunk=words,
        hash_ms_per_chunk=words * per_word / rate * 1e3)
    return out


def clt_probe_case(n_paths, dev, seed):
    """(ops, keywords) of one probe chunk with the CLT experiments' inputs:
    a = 1.005, b = 1/120, 360 months, v0 1000, target 2000, the 4094-bin
    spec of GaussianReturns."""
    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.engine import engine as eng

    spec = eng.make_histogram_spec(smt.GaussianReturns(), smt.NoWithdrawal(),
                                   CLT_MONTHS, CLT_V0, 4094)
    arow, cs = clt.block_consts(np.float32(CLT_A), np.float32(CLT_B),
                                CLT_MONTHS)
    ops = (clt.q_tensor(dev), torch.as_tensor(arow, device=dev),
           torch.as_tensor(cs, device=dev))
    kw = dict(seed_base=seed, tile0=0, valid=n_paths, n_paths=n_paths,
              v0=CLT_V0, target=CLT_TARGET, lo=spec.lo, log_lo=spec.log_lo,
              inv_w=1.0 / spec.width, hb=spec.n_bins + 2, with_hist=True,
              keep_finals=False)
    return ops, kw


def clt_ablation_report(n_paths=N, device="cuda", k=headline.K,
                        reps=headline.REPS):
    """``exp_clt_ablate.py`` (seed 99): per variant the mean of the finals,
    the count below 2000 and the histogram's mass; on the card its ms a
    chunk and base's ms less its own (exp_clt_ablate.py:178-180)."""
    dev = _device(device)
    ops, kw = clt_probe_case(n_paths, dev, ABLATE_SEED)
    variants = {}
    for ablate in clt.ABLATIONS:
        stats, hist, _ = clt.clt_probe_chunk(*ops, ablate=ablate, **kw)
        stats = stats.cpu().numpy()
        entry = dict(mean=float(stats[1] / stats[0]),
                     count_below=int(stats[7]),
                     hist_mass=int(hist.sum()))
        if dev.type == "cuda":
            launch, _ = clt.clt_probe_launcher(*ops, ablate=ablate, **kw)
            entry["ms"] = headline.events_ms(
                lambda i, launch=launch: launch(), k, reps)
        variants[ablate] = entry
    out = {"n_paths": n_paths, "months": CLT_MONTHS, "variants": variants}
    if dev.type == "cuda":
        base = variants["base"]["ms"]
        out["delta_ms"] = {v: base - variants[v]["ms"]
                           for v in clt.ABLATIONS if v != "base"}
    return out


def clt_grouping_report(n_paths=N, device="cuda", k=headline.K,
                        reps=headline.REPS):
    """``exp_clt_ts2.py`` (seed 77) at 0, 1, 2 and 4 tiles a block: whether
    finals, histogram, count below, min and max equal those at 0, the power
    sums' largest relative difference against 0, and on the card ms a
    chunk at each grouping."""
    dev = _device(device)
    ops, kw = clt_probe_case(n_paths, dev, GROUPING_SEED)
    runs, ms = {}, {}
    for ts in clt.GROUPINGS:
        runs[ts] = clt.clt_probe_chunk(*ops, ablate="base",
                                       tiles_per_block=ts,
                                       **dict(kw, keep_finals=True))
        if dev.type == "cuda":
            launch, _ = clt.clt_probe_launcher(*ops, ablate="base",
                                               tiles_per_block=ts, **kw)
            ms[str(ts)] = headline.events_ms(
                lambda i, launch=launch: launch(), k, reps)
    s0, h0, f0 = runs[0]
    same, sums_rel = {}, 0.0
    for ts in clt.GROUPINGS[1:]:
        s, h, f = runs[ts]
        same[str(ts)] = bool(torch.equal(f, f0) and torch.equal(h, h0)
                             and torch.equal(s[5:8], s0[5:8])
                             and bool(s[0] == s0[0]))
        sums_rel = max(sums_rel, float(((s[1:5] - s0[1:5]).abs()
                                        / s0[1:5].abs()).max()))
    out = {"n_paths": n_paths, "tiles_per_block": list(clt.GROUPINGS),
           "identical_to_ts0": same, "power_sums_max_rel_diff": sums_rel}
    if ms:
        out["ms"] = ms
    return out


def byte_stats(planes):
    """``exp_prng_bytes.py``'s host statistics of (seeds, 4 * 1024, 128)
    planes, in float64: the words, the byte means (127.5 expected), the 4x4
    byte correlation matrix and corr(lo16, hi16)."""
    p = np.asarray(planes, np.float64)
    x = np.concatenate([o.reshape(4, -1) for o in p], axis=1)
    lo16 = x[0] + 256 * x[1]
    hi16 = x[2] + 256 * x[3]
    return {"n_words": int(x.shape[1]),
            "byte_means": x.mean(axis=1).tolist(),
            "byte_corr": np.corrcoef(x).tolist(),
            "corr_lo16_hi16": float(np.corrcoef(lo16, hi16)[0, 1])}


def crossword_stats(planes):
    """``exp_prng_crossword.py:100-123`` as written, in float64 over
    (seeds, 4 * 1024, 128) planes: three byte planes mixed through Q and
    its column constants (the port's ``clt_qmatrix``), z = plane @ Q * cs -
    sh; the z planes' stds, Var(S) of the 360-month z sum and its ratio to
    360, and the cross-block and within-block covariance summaries.

    The file mixes bytes (0-255) through constants made for 16-bit counts
    (0-65535): z is centred and scaled for a uniform count, so a byte's z
    is its column's -sh plus a term whose std is 2^-8 of 1. The planes'
    stds (over paths and columns, as the file takes them) measure the
    spread of sh across columns, and Var(S) is about 2^-16 of 360 on any
    stream: neither ratio measures the stream. Only the covariances'
    off-diagonal terms, against their diagonals, would show a cross-word
    structure."""
    bits, colscale, colshift = clt.clt_qmatrix()
    qf = torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).to(torch.float64).numpy()
    cs = colscale.astype(np.float64)
    sh = colshift.astype(np.float64)
    k = clt.CLT_K
    zs = []
    for o in np.asarray(planes, np.float64):
        o = o.reshape(4, bp.ROWS, k)
        zs.append(np.stack([o[b] @ qf * cs - sh for b in range(3)]))
    z = np.concatenate(zs, axis=1)
    n = z.shape[1]
    live2 = CLT_MONTHS - 2 * k
    s = z[0].sum(1) + z[1].sum(1) + z[2][:, :live2].sum(1)
    centred = [z[a] - z[a].mean(0) for a in range(3)]
    cross, within = {}, {}
    for a, b in ((0, 1), (0, 2), (1, 2)):
        c = centred[a].T @ centred[b] / n
        cross[f"{a}{b}"] = dict(
            diag_mean=float(np.diag(c).mean()),
            offdiag_mean=float((c.sum() - np.trace(c)) / (k * k - k)),
            total_sum=float(c.sum()))
    for a in range(3):
        c = centred[a].T @ centred[a] / n
        off = c.sum() - np.trace(c)
        within[str(a)] = dict(offdiag_mean=float(off / (k * k - k)),
                              total_offdiag=float(off))
    return {"n_paths": n, "z_plane_stds": z.std(axis=(1, 2)).tolist(),
            "var_s": float(s.var()), "var_s_over_360": float(s.var() / 360),
            "cross_block": cross, "within_block": within}


def _planes_report(seeds, stats, device, k, reps):
    dev = _device(device)
    out = dict(seeds=list(seeds),
               **stats(bp.byte_planes(seeds, dev).cpu().numpy()))
    if dev.type == "cuda":
        launch, _ = bp.byte_planes_launcher(seeds, dev)
        out["ms"] = headline.events_ms(lambda i: launch(), k, reps)
    return out


def byte_planes_report(seeds=bp.BYTES_SEEDS, device="cuda", k=headline.K,
                       reps=headline.REPS):
    """``exp_prng_bytes.py`` at its 8 seeds on the counter stream."""
    return _planes_report(seeds, byte_stats, device, k, reps)


def crossword_report(seeds=bp.CROSSWORD_SEEDS, device="cuda", k=headline.K,
                     reps=headline.REPS):
    """``exp_prng_crossword.py`` at its 16 seeds on the counter stream."""
    return _planes_report(seeds, crossword_stats, device, k, reps)


REPORTS = ("hist", "flatten", "toys", "ablation", "grouping", "bytes",
           "crossword")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m stock_market_monte_carlo_torch.bench.probes",
        description="The experiment probes' reports (one JSON line).")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--n", type=int, default=N,
                   help="inputs of each histogram and paths of the CLT "
                        "probes, a multiple of 8192")
    p.add_argument("--only", nargs="+", choices=REPORTS, default=REPORTS,
                   help="the reports to run (default: all)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.n <= 0 or args.n % histogram.TILE:
        raise SystemExit(f"--n must be a positive multiple of "
                         f"{histogram.TILE}")
    runs = {
        "hist": lambda: hist_report(args.n, args.device),
        "flatten": lambda: flatten_report(args.n // histogram.TILE,
                                          args.device),
        "toys": lambda: clt_toys_report(device=args.device),
        "ablation": lambda: clt_ablation_report(args.n, args.device),
        "grouping": lambda: clt_grouping_report(args.n, args.device),
        "bytes": lambda: byte_planes_report(device=args.device),
        "crossword": lambda: crossword_report(device=args.device),
    }
    record = {
        "device": args.device,
        "card": headline.card_line() if args.device == "cuda" else None,
    }
    for name in REPORTS:
        if name in args.only:
            record[name] = runs[name]()
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
