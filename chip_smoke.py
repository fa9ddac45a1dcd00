"""GPU smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version on the card, drives the main paths at
100M paths x 360 months (historical month loop, terminal law, Gaussian ICDF
month loop, CLT sampler, the Sobol Gaussian, Sobol historical and
reference-parity historical month loops, historical bands in hist mode,
Gaussian bands in cdf mode, and the historical month loop with a
20000-bin histogram counted by the histogram kernel), checks
replicated-RQMC intervals, Sobol bands and trajectories on the card
against the CPU, holds the band kernels against their plain versions at
adversarial thresholds too (tied, past float32, a depleting hostile
table) and prints their launch plans, holds the histogram kernel's three
modes and the tile flatten against their plain versions and np.bincount
(and times the flatten and Tensor.copy_ in turns), the CLT and law
chunks of an odd histogram and the Sobol draws at 1866 months against
their plain versions, times the kernels and the paths, runs the histogram
probes' reports (``bench/probes.py``) and the headline benchmark
(``bench/headline.py``) at 100M x 360 with its dispatch-floor and
calibration kernels; then the experiment probes of the CLT and the
counter stream: the op-class toys, the CLT's ablation and tile-grouping
instances and the byte planes against their plain versions, the
production CLT's SASS against the parent build's and its time against the
same run's, and the probes' five reports. The run kernel
(``csrc/run_loop.cu``: the Gaussian ICDF and the Sobol draws) also: its
ptxas resources and launch plans, its instances against the plain version
(the Sobol draws at 64-bit positions, under every strategy, at 1866 months
and at the main path's first and ragged last chunk); and the month loop's
historical and reference instances' registers and spills. The band
histogram also at an odd number of cells too many for a window of more
than two months, and its launch plan (months a window, windows). Then the
long runs: the bare launchers holding their outputs after their outputs
closure is dropped; the historical, Gaussian ICDF and CLT samplers at 1e9
x 360 against their exact laws (``bench/validation.py``); and the scale
and fault drill (``bench/fault_drill.py``): a checkpointed 1e9 x 360 run
killed with SIGKILL in a child process, resumed and held to an
uninterrupted one bit for bit, the terminal law at 1e10 x 360, the month
loop at 1e9 x 360, and the cost of a checkpoint. Last, the paths mesh
(``parallel/mesh.py``) at 100M x 360: a 1-rank NCCL mesh in this process
and a 2-rank gloo mesh of two child processes that share the card, each
equal to the single-device runs bit for bit (the historical month loop
and the law; the children also bands in hist mode and replicated RQMC),
a checkpoint of the 2-rank run resumed on one device, and the headline's
``--mesh 2`` refusing on one card. Last, the user surfaces (phase 12),
through the CLI's ``main([...])`` on the card: ``benchmark-mc-gpu 1 360
100000000`` and ``benchmark-mc-reduceblock 1 360 100000000
--terminal-law``, each launching only its kernel and equal to a direct
``run`` bit for bit; the device mean and vector add at 2^24; CSVs of
``monte-carlo-historical`` read back as the run's trajectories; the
native library built and held to its Python versions; ``benchmark-google``
and ``benchmark-compare``; and the sweep (``bench/sweep.py``) at full
size, which launches the ICDF and Sobol loops, the CLT, both band kernels
and the law.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them, or when any
phase fails. Each phase prints one line. The line before the last holds
the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import math
import os
import re
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

GOLDEN_N = 8192 + 777
# the arithmetic stream's goldens (tests/test_arith_golden.py): the
# historical one holds bit for bit, the CLT one within the JAX package's
# own hardware bar (tests/test_tpu_only.py, 2e-5: tensor-core product and
# log/exp differ from XLA's CPU versions in the last bits)
GOLDEN = dict(t=7, head=[1084.7064, 1232.139, 1078.0762, 1086.5796],
              probes={1000: 1001.9213, 8192: 1077.0131, -1: 853.8689},
              total=9334839.723266602)
GOLDEN_CLT = dict(t=7, head=[1001.21185, 1041.5238, 1029.5404, 1031.0122],
                  probes={1000: 1034.0186, 8192: 1024.9257, -1: 1055.2952},
                  total=9286861.409606934)
GOLDEN_CLT_REL = 2e-5
# CLT kernel against its plain version: the bf16 x bf16 product accumulates
# in float32 in the tensor cores' order, torch.matmul in its own; the
# difference compounds through 360 months of logs (measured 1.6e-6)
CLT_REL = 1e-5
# a mean, std or withdrawn total over ~1e6 finals whose errors do not line up
MOMENT_REL = 1e-6
MAIN_PATHS = 100_000_000
# the long runs' paths: the samplers against their laws, the fault drill
LONG_PATHS = 1_000_000_000
MAIN_MONTHS = 360
CHUNK = 1 << 24
# paths of the kernel-against-plain checks at the main paths' months
CHECK_PATHS = 1 << 20
# valid paths that end inside the historical month loop's 256-path items
PARTIAL_ITEMS = (1, 255, 257, 2 * 8192 + 1001)
DEVICE = torch.device("cuda")
_PE = "stock_market_monte_carlo_tpu/ops/pallas_engine.py"
_PB = "stock_market_monte_carlo_tpu/ops/pallas_bands.py"
_EXP = "experiments"
_CSRC = "stock_market_monte_carlo_torch/csrc"
KERNELS = {
    "month_loop": dict(source=f"{_CSRC}/month_loop.cu",
                       replaces=f"{_PE}:1097"),
    "month_loop_gaussian": dict(source=f"{_CSRC}/run_loop.cu",
                                replaces=f"{_PE}:1097"),
    "month_loop_sobol_gaussian": dict(source=f"{_CSRC}/run_loop.cu",
                                      replaces=f"{_PE}:1097"),
    "month_loop_sobol_historical": dict(source=f"{_CSRC}/run_loop.cu",
                                        replaces=f"{_PE}:1097"),
    "month_loop_reference": dict(source=f"{_CSRC}/month_loop.cu",
                                 replaces=f"{_PE}:1097"),
    "law": dict(source=f"{_CSRC}/terminal_law.cu", replaces=f"{_PE}:1445"),
    "clt": dict(source=f"{_CSRC}/clt.cu", replaces=f"{_PE}:1048"),
    "bands_hist": dict(source=f"{_CSRC}/bands.cu", replaces=f"{_PB}:249"),
    "bands_cdf": dict(source=f"{_CSRC}/bands.cu", replaces=f"{_PB}:494"),
    "grid_overhead": dict(source=f"{_CSRC}/calibration.cu",
                          replaces=f"{_EXP}/exp_grid_overhead.py:66"),
    "calib": dict(source=f"{_CSRC}/calibration.cu",
                  replaces=f"{_EXP}/exp_hist_roofline.py:102"),
    "counts_below_tile": dict(source=f"{_CSRC}/bands.cu",
                              replaces="tests/test_bands.py:468"),
    # the engine's histogram of finals the chunk kernels cannot bin in
    # place: the JAX package's XLA epilogue (bin_index, histogram_counts)
    "histogram": dict(source=f"{_CSRC}/histogram.cu",
                      replaces=f"{_PE}:1758"),
    # both TPU layouts of the int32-index histogram are this one kernel
    "histogram_index": dict(source=f"{_CSRC}/histogram.cu",
                            replaces=f"{_EXP}/exp_pallas_hist.py:40"),
    "histogram_index_rows": dict(source=f"{_CSRC}/histogram.cu",
                                 replaces=f"{_EXP}/exp_rowhist.py:40"),
    "histogram_clip_cast": dict(source=f"{_CSRC}/histogram.cu",
                                replaces=f"{_EXP}/exp_flatten_cost.py:65"),
    "flatten_tile": dict(source=f"{_CSRC}/histogram.cu",
                         replaces=f"{_EXP}/exp_flatten_cost.py:29"),
    # the op-class toys: one template, an instance a class; hash is the
    # port's own class (the counter word the CLT hashes per count)
    **{f"op_toy_{op}": dict(source=f"{_CSRC}/calibration.cu",
                            replaces=f"{_EXP}/exp_clt_roofline.py:104")
       for op in ("mul", "fma", "iadd", "shf", "cvt", "mm", "hash")},
    # the CLT's probe instances: ablations, and base at 1, 2, 4 tiles a block
    **{f"clt_probe_{a}": dict(source=f"{_CSRC}/clt.cu",
                              replaces=f"{_EXP}/exp_clt_ablate.py:146")
       for a in ("base", "nohist", "nologexp", "nodraw", "nomm")},
    **{f"clt_probe_ts{t}": dict(source=f"{_CSRC}/clt.cu",
                                replaces=f"{_EXP}/exp_clt_ts2.py:112")
       for t in (1, 2, 4)},
    "byte_planes": dict(source=f"{_CSRC}/byte_planes.cu",
                        replaces=f"{_EXP}/exp_prng_bytes.py:34"),
    "byte_planes_crossword": dict(source=f"{_CSRC}/byte_planes.cu",
                                  replaces=f"{_EXP}/exp_prng_crossword.py:41"),
}
# the record's entry of a kernel -> the launch counter it reads
COUNTER_OF = {"histogram_index_rows": "histogram_index"}
# the histogram kernel's cell counts: in 48 KB of shared memory, past the
# default 48 KB inside a block's opt-in 227 KB, past a block's shared
# memory (the global-atomic cells)
HIST_CELLS = (4096, 20000, 70000)
# the engine's histogram off the in-place 4096 cells, and a count of cells
# that is not a multiple of 64
BIG_BINS = 20000
ODD_BINS = 4000
# the Sobol table's dimensions: the longest Sobol horizon
SOBOL_MONTHS = 1866
BAND_BINS = 1024
# a band histogram of 20003 cells: two months a window (80 KB each), 180
# windows at 360 months
BAND_ODD_BINS = 20001
BAND_THRESHOLDS = 32
# the median band of a 100M-path run against the exact marginal law
BAND_MEDIAN_REL = 0.01
BAND_MONTHS = (12, 120, 360)
TRAJ_PATHS = 10_000
# trajectories on the card against the CPU: the two devices' log1p and the
# cumulative product's order differ in the last bits, which compound over
# 360 months (the CPU tests hold the port to the JAX package at 3e-5)
TRAJ_REL = 3e-5
# a Sobol run positioned past 2^33: 64-bit positions, the (T, 64) table
DEEP_OFFSET = (1 << 33) + 777
RQMC_REPLICATES = 8
RQMC_PATHS = 1 << 24
SOBOL_BAND_PATHS = 1 << 22
# the headline's seeds of the dispatch floor and the calibration pair
GRID_SEED = 12345
CALIB_SEED = 123
# a ragged tile offset for the calibration check
CALIB_TILE0 = 37
COUNTS_K = (8, 32, 64)
# tile counts of the flatten besides the main 2048 (a block copies a tile):
# one block, and an odd grid
FLATTEN_ODD_TILES = (1, 2047)
# the headline's mean errors against 1000 * g^360
HEADLINE_MEAN_REL = 1e-3
# the mm toy against its plain version, relative to a row's largest
# magnitude: an accumulation-order ulp on a bf16 rounding edge moves an
# element by 2^-8 of itself, which Q spreads over the row
MM_ROW_REL = 1e-3
# SASS instructions (NOPs left out) of the production CLT kernels, variant
# -> count, in the build of the commit that last changed clt.cu (the
# wgmma product and the finish in the accumulators' layout):
# calibration.clt_production_sass, nvcc of CUDA 12.8 on the H100 machine;
# the probe instances must leave them as they are
CLT_SASS_PARENT = {0: 3270, 1: 3270, 2: 1872}
# the production CLT's time in the probes' phase against phase 6's
CLT_TIME_REL = 0.02
# the byte planes: means within 127.5 +- 0.5, off-diagonal |corr| < 0.01
# at ~1e6 words (sd ~1e-3)
BYTE_MEAN_TOL = 0.5
BYTE_CORR_MAX = 0.01
BAND_QS = (0.05, 0.5, 0.95)
# the paths mesh (phase 11): two gloo ranks on the one card; the timeout of
# their start, runs and collectives; RQMC's chunk there (a replicate of
# 2^24 paths is one 2^23-path chunk a rank, as on one device at 2^23); the
# checkpointed run stops after this many dispatches and resumes on one
# device at half the chunk (and at the same chunk, bit for bit)
MESH_RANKS = 2
MESH_TIMEOUT_S = 600.0
MESH_RQMC_CHUNK = RQMC_PATHS // 2
MESH_STOP_AFTER = 2
RESUME_CHUNK = CHUNK // 2
# the 1-rank NCCL mesh's walls against the single device's: medians of
# this many runs, in turns
MESH_REPS = 3
# phase 12, the user surfaces: the reference's own GPU row (BASELINE.md,
# 1e8 x 360 historical, mean/var only, on an RTX 3070), the CLI's sizes
# and the sweep's kernels (launch counter -> what it is)
RTX3070_S = 0.13
CLI_PATHS, CLI_MONTHS = 100_000_000, 360
CLI_VECTOR = 16_777_216
CLI_CSV_PATHS, CLI_GOOGLE_PATHS = 8, 1_000_000
SWEEP_KERNELS = {"month_loop_gaussian": "ICDF loop",
                 "month_loop_sobol_gaussian": "Sobol loop",
                 "clt": "CLT", "bands_hist": "band histogram",
                 "bands_cdf": "band cdf", "law": "law kernel"}

def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# One chunk's operands, as engine._chunk_fn builds them.
# ---------------------------------------------------------------------------


def _common(model, strategy, n_periods, valid, n_paths, target, tile0,
            bins=4094):
    from stock_market_monte_carlo_torch.engine import engine as eng

    spec = eng.make_histogram_spec(model, strategy, n_periods, 1000.0, bins)
    return dict(tile0=tile0, valid=valid, n_paths=n_paths, v0=1000.0,
                target=target,
                shift=eng.analytic_moment_shift(model, strategy, n_periods),
                lo=spec.lo, log_lo=spec.log_lo, inv_w=1.0 / spec.width,
                hb=spec.n_bins + 2, with_hist=True, keep_finals=True)


def _keep(strategy, n_periods):
    from stock_market_monte_carlo_torch.engine import engine as eng

    return (eng._keep_factors_np(strategy, n_periods)
            if eng._is_multiplicative(strategy)
            else np.ones((n_periods,), np.float32))


def _base(seed):
    from stock_market_monte_carlo_torch.engine import engine as eng

    return eng._segment_base(seed, 0)


def template_args(mangled, kernel):
    """"<1,0,1>": the integer and bool template arguments of ``kernel`` in
    a mangled name, or None where the name is not that kernel's."""
    m = re.search(rf"{kernel}I((?:L[ib]\d+E)+)E", mangled)
    return ("<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(1))) + ">"
            if m else None)


def month_chunk_args(model, strategy, n_periods, valid, n_paths, target,
                     seed, tile0=0, bins=4094):
    """(table, keep), kwargs of one month-loop chunk; the draw follows the
    model (historical table, Gaussian a + b*z, the Sobol draws with the
    seed's digital shift, the reference stream)."""
    from stock_market_monte_carlo_torch.engine import engine as eng
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce
    from stock_market_monte_carlo_torch.ops import sobol

    shift = (sobol.digital_shift(eng._scramble_key(seed, DEVICE), n_periods)
             if model.is_quasi else None)
    table, draw = ce.draw_operands(model, DEVICE, n_periods, shift)
    kw = dict(_common(model, strategy, n_periods, valid, n_paths, target,
                      tile0, bins),
              strategy=strategy.kind,
              amount=float(getattr(strategy, "amount", 0.0)),
              n_periods=n_periods, seed_base=_base(seed), **draw)
    return (table, torch.as_tensor(_keep(strategy, n_periods),
                                   device=DEVICE)), kw


def law_chunk_args(model, n_periods, valid, n_paths, target, seed,
                   keep_finals, tile0=0, bins=4094):
    from stock_market_monte_carlo_torch.models.strategies import NoWithdrawal
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce
    from stock_market_monte_carlo_torch.ops import terminal_law as tlaw

    none = NoWithdrawal()
    op = tlaw.fit_terminal_law(model, none, n_periods, 1000.0).operand()
    kw = dict(_common(model, none, n_periods, valid, n_paths, target, tile0,
                      bins),
              seed_base=_base(seed) ^ ce.LAW_STREAM_XOR,
              inv_zmax=1.0 / tlaw.LAW_ZMAX, keep_finals=keep_finals,
              law_host=op)
    return (torch.as_tensor(op, device=DEVICE),), kw


def band_chunk_args(model, strategy, kind, n_periods, valid, n_paths, seed,
                    tile0=0, n_bins=BAND_BINS):
    """(table, keep, coef_a, coef_b), kwargs of one band chunk with the
    coefficients simulate_bands builds; ``kind`` "hist" (of ``n_bins``
    bins) or "cdf"."""
    from stock_market_monte_carlo_torch.engine import bands as bands_eng
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    centers, scales = bands_eng.band_grid(model, strategy, n_periods, 1000.0)
    if kind == "hist":
        ca, cb, _ = bands_eng.hist_coefficients(centers, scales, n_bins,
                                                1000.0)
        reduce_kw = dict(n_bins=n_bins, coef_a_host=ca)
    else:
        ca, cb, klo, khi, _, _ = bands_eng.cdf_coefficients(
            centers, scales, BAND_THRESHOLDS, 1000.0)
        reduce_kw = dict(kappa_lo=klo, kappa_hi=khi,
                         n_thresholds=BAND_THRESHOLDS, coef_b_host=cb)
    table, draw = ce.draw_operands(model, DEVICE)
    keep = (None if strategy.kind == "none"
            else torch.as_tensor(_keep(strategy, n_periods), device=DEVICE))
    kw = dict(n_periods=n_periods, seed_base=_base(seed), tile0=tile0,
              valid=valid, n_paths=n_paths, v0=1000.0, **draw, **reduce_kw)
    return (table, keep, torch.as_tensor(ca, device=DEVICE),
            torch.as_tensor(cb, device=DEVICE)), kw


def clt_chunk_args(variant, strategy, n_periods, valid, n_paths, target,
                   seed, tile0=0, bins=4094):
    """(q, arow, cs, keep_rows), kwargs of one CLT chunk of the default
    GaussianReturns model."""
    from stock_market_monte_carlo_torch.models.market import GaussianReturns
    from stock_market_monte_carlo_torch.ops import clt
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    model = GaussianReturns()
    keep = _keep(strategy, n_periods)
    a, b = ce.gaussian_ab(model.mean_pct, model.std_pct)
    arow, cs = clt.block_consts(a, b, n_periods,
                                keep if variant == "keep_fold" else None)
    ops = (clt.q_tensor(DEVICE), torch.as_tensor(arow, device=DEVICE),
           torch.as_tensor(cs, device=DEVICE),
           torch.as_tensor(clt.keep_rows(keep, n_periods), device=DEVICE)
           if variant == "prefix" else None)
    kw = dict(_common(model, strategy, n_periods, valid, n_paths, target,
                      tile0, bins),
              variant=variant, seed_base=_base(seed) ^ clt.CLT_STREAM_XOR)
    return ops, kw


# ---------------------------------------------------------------------------
# Kernel output against plain output.
# ---------------------------------------------------------------------------


def moments_of(stats, shift):
    from stock_market_monte_carlo_torch.engine.engine import _absorb
    from stock_market_monte_carlo_torch.ops import reductions as red

    tot, _, _ = _absorb(((stats, np.zeros(1)), 0, 0),
                        red.zero_packed_stats(), np.zeros(1), [], False,
                        np.ones(9), shift)
    return red.MomentSummary.from_packed(tot, True)


def compare_chunk(label, k_out, p_out, kw, finals_rel):
    """Kernel output against plain output; returns the largest absolute
    and relative finals differences (0.0 when the kernel wrote no
    finals).

    finals_rel == 0 (the month loop and the law, bit-equal to their plain
    versions): counts, min, max and finals exact, histogram cells within
    2. Otherwise (CLT, at CLT_REL): finals, min and max within
    finals_rel; the count below the target may differ only by the plain
    finals within finals_rel of the target, and the histograms only by the
    plain finals within finals_rel of a bin edge (in log space), each
    moving one count. Always: path count and histogram mass exact; mean,
    std and withdrawn within MOMENT_REL. The plain output must hold
    finals."""
    torch.cuda.synchronize()
    sk, hk, fk = k_out
    sp, hp, fp = p_out
    fp64 = fp.double()
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    check(sk[0] == sp[0], f"{label}: path counts {sk[0]} vs {sp[0]}")
    hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
    check(hk.sum() == hp.sum() == sk[0],
          f"{label}: histogram mass {hk.sum()} vs {hp.sum()}")
    if finals_rel == 0.0:
        check(sk[7] == sp[7], f"{label}: count below {sk[7]} vs {sp[7]}")
        check(sk[5] == sp[5] and sk[6] == sp[6],
              f"{label}: min/max {sk[5:7]} vs {sp[5:7]}")
        check(np.abs(hk - hp).max() <= 2,
              f"{label}: histogram cells differ by {np.abs(hk - hp).max()}")
    else:
        near_target = int(((fp64 / kw["target"] - 1.0).abs()
                           <= finals_rel).sum())
        check(abs(sk[7] - sp[7]) <= near_target,
              f"{label}: count below {sk[7]} vs {sp[7]} ({near_target} "
              "finals near the target)")
        for i in (5, 6):
            check(rel(sk[i], sp[i]) <= finals_rel,
                  f"{label}: min/max {sk[5:7]} vs {sp[5:7]}")
        x = (torch.log(fp64) - kw["log_lo"]) * kw["inv_w"]
        near_edge = int(((x - torch.round(x)).abs()
                         <= finals_rel * kw["inv_w"] + 1e-9).sum())
        l1 = float(np.abs(hk - hp).sum())
        check(l1 <= 2 * near_edge,
              f"{label}: histograms differ by {l1} ({near_edge} finals "
              "near a bin edge)")
    mk, mp = moments_of(sk, kw["shift"]), moments_of(sp, kw["shift"])
    for field in ("mean", "std", "total_withdrawn"):
        a, b = getattr(mk, field), getattr(mp, field)
        check(a == b or rel(a, b) <= MOMENT_REL,
              f"{label}: {field} {a} vs {b}")
    if fk is None:
        return 0.0, 0.0
    fk64 = fk.double()
    err = float((fk64 - fp64).abs().max())
    r = float(((fk64 - fp64).abs() / fp64.abs()).max())
    if finals_rel == 0.0:
        check(torch.equal(fk, fp), f"{label}: finals differ (max {err})")
    else:
        check(r <= finals_rel, f"{label}: finals rel diff {r}")
    return err, r


def compare_counts(label, k_out, p_out, kind, valid):
    """Band counts of the kernel against the plain version: equal bit for
    bit; each histogram row holds ``valid`` paths, each counts-below row
    is non-decreasing and at most ``valid``. Returns the largest absolute
    difference (0)."""
    torch.cuda.synchronize()
    check(k_out.dtype == p_out.dtype == torch.int32
          and k_out.shape == p_out.shape,
          f"{label}: {k_out.dtype} {tuple(k_out.shape)} vs {p_out.dtype} "
          f"{tuple(p_out.shape)}")
    err = int((k_out.long() - p_out.long()).abs().max())
    check(torch.equal(k_out, p_out), f"{label}: counts differ by {err}")
    if kind == "hist":
        check(bool((k_out.long().sum(1) == valid).all()),
              f"{label}: a month's mass is not {valid}")
    else:
        check(bool((k_out.diff(dim=1) >= 0).all())
              and int(k_out.max()) <= valid,
              f"{label}: counts below not monotone or above {valid}")
    return err


def eng_spec(model, n_periods, bins):
    from stock_market_monte_carlo_torch.engine import engine as eng
    from stock_market_monte_carlo_torch.models.strategies import NoWithdrawal

    return eng.make_histogram_spec(model, NoWithdrawal(), n_periods, 1000.0,
                                   bins)


def hist_inputs(rng, hb, spec):
    """{mode: (input on the card, spec keywords)} of 2^24 inputs each:
    int32 indices over [-2, hb + 2] (hb is a masked lane's index), floats
    over [-50, hb + 50), and log-normal finals around the spec's range with
    lo, 0, +inf and NaN among them."""
    idx = rng.integers(-2, hb + 3, CHUNK).astype(np.int32)
    x = rng.uniform(-50.0, hb + 50.0, CHUNK).astype(np.float32)
    finals = np.exp(rng.uniform(spec.log_lo - 0.5, np.log(spec.hi) + 0.5,
                                CHUNK)).astype(np.float32)
    finals[:4] = (spec.lo, 0.0, np.inf, np.nan)
    spec_kw = dict(lo=spec.lo, log_lo=spec.log_lo, inv_w=1.0 / spec.width)
    return {"index": (torch.as_tensor(idx, device=DEVICE), {}),
            "clip_cast": (torch.as_tensor(x, device=DEVICE), {}),
            "spec": (torch.as_tensor(finals, device=DEVICE), spec_kw)}


def hist_bins(histogram, mode, x, hb, kw):
    """Host bins of a mode's input, those outside [0, hb) dropped."""
    if mode == "index":
        bins = x.cpu().numpy()
    elif mode == "clip_cast":
        bins = histogram.clip_cast_indices(x, hb).cpu().numpy()
    else:
        bins = histogram.spec_bin_indices(x, n_bins=hb - 2,
                                          **kw).cpu().numpy()
    return bins[(bins >= 0) & (bins < hb)]


def compare_probe(label, k_out, p_out, kw):
    """A CLT probe chunk against its plain version. Finals, min and max
    within CLT_REL, path count exact; the count below the target and the
    histogram exact but for plain finals within CLT_REL of the target or
    of a cell edge (each moving one count); the float64 power sums within
    1e-5. Returns (max abs and rel finals differences, whether the count
    below and the histogram were exact)."""
    torch.cuda.synchronize()
    sk, hk, fk = k_out
    sp, hp, fp = p_out
    fk64, fp64 = fk.double(), fp.double()
    err = float((fk64 - fp64).abs().max())
    r = float(((fk64 - fp64).abs() / fp64.abs()).max())
    check(r <= CLT_REL, f"{label}: finals rel diff {r}")
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
    check(sk[0] == sp[0], f"{label}: path counts {sk[0]} vs {sp[0]}")
    near_target = int(((fp64 / kw["target"] - 1.0).abs() <= CLT_REL).sum())
    check(abs(sk[7] - sp[7]) <= near_target,
          f"{label}: count below {sk[7]} vs {sp[7]} ({near_target} near)")
    for i in (5, 6):
        check(rel(sk[i], sp[i]) <= CLT_REL,
              f"{label}: min/max {sk[5:7]} vs {sp[5:7]}")
    for i in (1, 2, 3, 4):
        check(rel(sk[i], sp[i]) <= 1e-5,
              f"{label}: power sums {sk[1:5]} vs {sp[1:5]}")
    mass = 0 if kw.get("ablate") == "nohist" else sk[0]
    check(hk.sum() == hp.sum() == mass,
          f"{label}: histogram mass {hk.sum()} vs {hp.sum()}")
    x = (torch.log(fp64) - kw["log_lo"]) * kw["inv_w"]
    near_edge = int(((x - torch.round(x)).abs()
                     <= CLT_REL * kw["inv_w"] + 1e-9).sum())
    l1 = float(np.abs(hk - hp).sum())
    check(l1 <= 2 * near_edge, f"{label}: histograms differ by {l1} "
                               f"({near_edge} finals near a bin edge)")
    return err, r, bool(sk[7] == sp[7] and l1 == 0)


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------


def wall_median(fn, reps=3):
    fn()  # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times), times


# ---------------------------------------------------------------------------
# The paths mesh (phase 11).
# ---------------------------------------------------------------------------


class _Stopped(Exception):
    pass


def moments_row(res):
    """A result's moments as one float64 row, for bit-for-bit checks."""
    m = res.moments
    return np.array([m.n, m.mean, m.var, m.std, m.min, m.max, m.skew,
                     m.kurtosis, m.count_below, m.total_withdrawn],
                    np.float64)


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def main_path_run(model, key, mesh=None, chunk_paths=CHUNK, **kw):
    """Phase 5's run of the historical month loop or the law (seed 0,
    target 2000, 2^24-path chunks) of ``model``, over ``mesh``."""
    import stock_market_monte_carlo_torch as smt

    return smt.simulate_stats(
        model, MAIN_PATHS, MAIN_MONTHS, target_amount=2000.0,
        options=smt.EngineOptions(terminal_law=key == "law",
                                  chunk_paths=chunk_paths),
        mesh=mesh, **kw)


def walls_of(fn, reps=MESH_REPS):
    """Walls of ``reps`` calls of ``fn``: host clock around each call and a
    synchronize."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return walls


def mesh_rank(mesh, checkpoint):
    """One rank of phase 11's 2-rank gloo mesh on the card (a child
    process of ``parallel/_ranks.py``): the historical month loop and the
    law at 100M x 360, historical bands in hist mode at 100M x 360 and the
    Sobol Gaussian RQMC at 8 x 2^24 x 360, each counted on its own (its
    first call; then MESH_REPS timed calls); then the checkpointed month
    loop, stopped by its progress callback on every rank after
    MESH_STOP_AFTER dispatches."""
    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    hist = smt.HistoricalBootstrap.from_csv()
    out = {}

    def counted(part, fn):
        ce.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        out[f"{part}/launches"] = json.dumps(ce.LAUNCHES)
        out[f"{part}/walls_s"] = walls_of(fn)
        return res

    for key in ("month_loop", "law"):
        res = counted(key, lambda: main_path_run(hist, key, mesh))
        out[f"{key}/moments"] = moments_row(res)
        out[f"{key}/hist"] = res.histogram_counts
    bands = counted("bands_hist", lambda: smt.simulate_bands(
        hist, MAIN_PATHS, MAIN_MONTHS, quantile_levels=BAND_QS,
        sample_paths=32, band_mode="hist", n_bins=BAND_BINS, mesh=mesh))
    out.update({"bands_hist/values": bands.values,
                "bands_hist/month_hist": bands.month_hist,
                "bands_hist/sample_paths": bands.sample_paths})
    est = counted("month_loop_sobol_gaussian", lambda: smt.rqmc_estimate(
        smt.SobolGaussianReturns.create(MAIN_MONTHS), RQMC_PATHS,
        MAIN_MONTHS, replicates=RQMC_REPLICATES, confidence=0.99,
        options=smt.EngineOptions(chunk_paths=MESH_RQMC_CHUNK), mesh=mesh))
    out["month_loop_sobol_gaussian/replicate_means"] = est.replicate_means
    calls = []

    def stop(done, total):
        calls.append(done)
        if len(calls) == MESH_STOP_AFTER:
            raise _Stopped()

    try:
        main_path_run(hist, "month_loop", mesh, checkpoint_path=checkpoint,
                      progress=stop)
    except _Stopped:
        pass
    else:
        raise RuntimeError("the checkpointed mesh run was not stopped")
    out["checkpoint/calls"] = np.array(calls)
    return out


def mesh_phase(card, main_results, band_results):
    """Phase 11: the paths mesh at 100M x 360 (see the module docstring).
    Returns the record it prints."""
    import torch.distributed as dist

    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.bench import headline
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce
    from stock_market_monte_carlo_torch.parallel._ranks import run_ranks
    from stock_market_monte_carlo_torch.parallel.mesh import PathsMesh

    n_chunks = -(-MAIN_PATHS // CHUNK)
    dispatches = -(-MAIN_PATHS // (CHUNK * MESH_RANKS))
    hist = smt.HistoricalBootstrap.from_csv()
    record = {}

    # 11a. a 1-rank NCCL mesh in this process (paths_mesh(1) is the
    # single-device path, so the mesh is built here): the same launches,
    # plus one all-gather of the stacked rows a flush
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            mesh = PathsMesh(group=None, rank=0, size=1, backend="nccl",
                             device=torch.device(
                                 "cuda", torch.cuda.current_device()))
            for key in ("month_loop", "law"):
                ce.reset_launch_counts()
                res = main_path_run(hist, key, mesh)
                torch.cuda.synchronize()
                counts = dict(ce.LAUNCHES)
                want = dict({k: 0 for k in counts}, **{key: n_chunks})
                check(counts == want, f"NCCL mesh {key}: launches {counts}")
                base = main_results[key]
                check(same_bits(moments_row(res), moments_row(base))
                      and same_bits(res.histogram_counts,
                                    base.histogram_counts),
                      f"NCCL mesh {key}: {res.moments} vs {base.moments}")
                # the 9 packed sums, through a stream callback on both
                ups = {}
                for arm, m in (("single", None), ("mesh", mesh)):
                    updates = []
                    main_path_run(hist, key, m, stream=updates.append)
                    ups[arm] = updates[-1].stats
                check(same_bits(ups["single"], ups["mesh"]),
                      f"NCCL mesh {key}: packed sums {ups}")
                walls = {"single": [], "mesh": []}
                for rep in range(MESH_REPS):
                    for arm in (("single", "mesh") if rep % 2 == 0
                                else ("mesh", "single")):
                        m = mesh if arm == "mesh" else None
                        walls[arm] += walls_of(
                            lambda: main_path_run(hist, key, m), 1)
                med = {arm: statistics.median(w) for arm, w in walls.items()}
                rec = dict(backend="nccl", world_size=1, launches=counts[key],
                           walls_s=walls, median_s=med,
                           mesh_minus_single_s=med["mesh"] - med["single"])
                record[f"nccl1_{key}"] = rec
                say(11, f"[{card}] 1-rank NCCL mesh {key} 100M x 360: "
                        f"{counts[key]} launches; moments, 9 packed sums and "
                        f"{base.histogram_counts.size} cells == single "
                        f"device; {json.dumps(rec)}")
        finally:
            dist.destroy_process_group()

    # 11b and 11c. two gloo ranks, child processes sharing the card
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.npz")
        t = time.perf_counter()
        ranks = run_ranks(MESH_RANKS, "chip_smoke:mesh_rank",
                          dict(checkpoint=path), backend="gloo",
                          device="cuda", timeout=MESH_TIMEOUT_S)
        children_s = time.perf_counter() - t
        sobol = smt.SobolGaussianReturns.create(MAIN_MONTHS)
        single_rqmc = smt.rqmc_estimate(
            sobol, RQMC_PATHS, MAIN_MONTHS, replicates=RQMC_REPLICATES,
            confidence=0.99,
            options=smt.EngineOptions(chunk_paths=MESH_RQMC_CHUNK))
        expected = {"month_loop": dispatches, "law": dispatches,
                    "bands_hist": dispatches,
                    "month_loop_sobol_gaussian": RQMC_REPLICATES}
        bands = band_results["bands_hist"]
        for rank, r in enumerate(ranks):
            for part, n in expected.items():
                counts = json.loads(str(r[f"{part}/launches"]))
                want = dict({k: 0 for k in counts}, **{part: n})
                check(counts == want,
                      f"gloo rank {rank} {part}: launches {counts}")
            for key in ("month_loop", "law"):
                base = main_results[key]
                check(same_bits(r[f"{key}/moments"], moments_row(base))
                      and same_bits(r[f"{key}/hist"], base.histogram_counts),
                      f"gloo rank {rank} {key}: {r[f'{key}/moments']} vs "
                      f"{moments_row(base)}")
            check(same_bits(r["bands_hist/values"], bands.values)
                  and same_bits(r["bands_hist/month_hist"], bands.month_hist)
                  and same_bits(r["bands_hist/sample_paths"],
                                bands.sample_paths),
                  f"gloo rank {rank} bands: values {r['bands_hist/values']}"
                  f" vs {bands.values}")
            check(same_bits(r["month_loop_sobol_gaussian/replicate_means"],
                            single_rqmc.replicate_means),
                  f"gloo rank {rank} rqmc: "
                  f"{r['month_loop_sobol_gaussian/replicate_means']} vs "
                  f"{single_rqmc.replicate_means}")
            check(list(r["checkpoint/calls"]) == [
                CHUNK * MESH_RANKS * (i + 1) for i in range(MESH_STOP_AFTER)],
                f"gloo rank {rank} checkpoint: reports {r['checkpoint/calls']}")
        walls = {part: [r[f"{part}/walls_s"].tolist() for r in ranks]
                 for part in expected}
        medians = {part: [statistics.median(w) for w in v]
                   for part, v in walls.items()}
        record["gloo2"] = dict(backend="gloo", world_size=MESH_RANKS,
                               launches_a_rank=expected, walls_s=walls,
                               median_s=medians, children_wall_s=children_s)
        say(11, f"[{card}] 2-rank gloo mesh on one card (two child "
                f"processes): month loop, law, bands (hist) 100M x 360 and "
                f"RQMC {RQMC_REPLICATES} x {RQMC_PATHS} x {MAIN_MONTHS} == "
                f"the single device bit for bit on both ranks; launches a "
                f"rank {expected}; {json.dumps(record['gloo2'])}")

        # 11c. the 2-rank run's checkpoint resumed on one device: at half
        # the chunk (counts and cells exact, moments within MOMENT_REL) and
        # at the same chunk (bit for bit)
        base = main_results["month_loop"]
        resumed = {}
        for chunk in (RESUME_CHUNK, CHUNK):
            copy = os.path.join(tmp, f"resume{chunk}.npz")
            shutil.copy(path, copy)
            ce.reset_launch_counts()
            resumed[chunk] = main_path_run(hist, "month_loop",
                                           chunk_paths=chunk,
                                           checkpoint_path=copy)
            torch.cuda.synchronize()
            left = -(-(MAIN_PATHS - MESH_STOP_AFTER * MESH_RANKS * CHUNK)
                     // chunk)
            check(ce.LAUNCHES["month_loop"] == left,
                  f"resume at {chunk}: launches {ce.LAUNCHES}")
        half, same = resumed[RESUME_CHUNK], resumed[CHUNK]
        m, b = half.moments, base.moments
        check((m.n, m.min, m.max, m.count_below) == (b.n, b.min, b.max,
                                                     b.count_below)
              and np.array_equal(half.histogram_counts,
                                 base.histogram_counts)
              and rel(m.mean, b.mean) <= MOMENT_REL
              and rel(m.std, b.std) <= MOMENT_REL,
              f"resume at {RESUME_CHUNK}: {m} vs {b}")
        check(same_bits(moments_row(same), moments_row(base))
              and same_bits(same.histogram_counts, base.histogram_counts),
              f"resume at {CHUNK}: {same.moments} vs {b}")
        record["resume"] = dict(
            stopped_after_paths=MESH_STOP_AFTER * MESH_RANKS * CHUNK,
            half_chunk_mean_rel=rel(m.mean, b.mean),
            half_chunk_std_rel=rel(m.std, b.std))
        say(11, f"2-rank checkpoint after {MESH_STOP_AFTER} dispatches "
                f"resumed on one device: at {RESUME_CHUNK}-path chunks "
                f"counts and cells exact, mean rel "
                f"{record['resume']['half_chunk_mean_rel']!r}, std rel "
                f"{record['resume']['half_chunk_std_rel']!r}; at {CHUNK} "
                f"bit for bit")

    # 11d. the headline's --mesh 2 on one card refuses before any launch,
    # naming the card count (on more cards, outside torchrun, the world)
    ce.reset_launch_counts()
    try:
        headline.main([str(MAIN_PATHS), str(MAIN_MONTHS), "--mesh",
                       str(MESH_RANKS)])
    except (RuntimeError, ValueError) as e:
        refusal = str(e)
    else:
        fail("headline --mesh 2 ran on one card")
    cards = torch.cuda.device_count()
    named = (f"this machine has {cards}" if cards < MESH_RANKS
             else "WORLD_SIZE is 1")
    check(sum(ce.LAUNCHES.values()) == 0 and named in refusal,
          f"headline --mesh 2: {refusal!r}, launches {ce.LAUNCHES}")
    say(11, f"headline --mesh {MESH_RANKS} on {cards} card(s) refuses "
            f"before any launch: {refusal}")
    return record


# ---------------------------------------------------------------------------
# The user surfaces (phase 12).
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded(names):
    """Record every call of the package's entry points ``names`` made
    inside the block: [(name, result), ...]."""
    import stock_market_monte_carlo_torch as smt

    calls, real = [], {n: getattr(smt, n) for n in names}

    def wrap(name):
        def fn(*a, **k):
            res = real[name](*a, **k)
            calls.append((name, res))
            return res
        return fn

    for n in names:
        setattr(smt, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in real.items():
            setattr(smt, n, f)


def cli(argv):
    """Stdout of ``smmc-torch <argv>`` run in process (its default device,
    the card), echoed."""
    from stock_market_monte_carlo_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    check(rc is None, f"smmc-torch {' '.join(argv)}: returned {rc!r}")
    text = out.getvalue()
    print(text, end="", flush=True)
    return text


def counted(fn):
    """(fn(), the launch counts of its run)."""
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    ce.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ce.LAUNCHES)


def surfaces_phase(card):
    """Phase 12: the user's commands on the card, through the CLI's
    ``main([...])`` (see the module docstring)."""
    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch import native
    from stock_market_monte_carlo_torch.bench import sweep
    from stock_market_monte_carlo_torch.data import loader
    from stock_market_monte_carlo_torch.ops import reductions, sobol
    from stock_market_monte_carlo_torch.utils.io import read_data_file

    hist_model = smt.HistoricalBootstrap.from_csv()
    n_chunks = -(-CLI_PATHS // CHUNK)

    # 12a. benchmark-mc-gpu and benchmark-mc-reduceblock --terminal-law:
    # each launches only its kernel, and its result is a direct run's
    # with the CLI's arguments bit for bit
    for argv, key, opts in (
            (["benchmark-mc-gpu", "1"], "month_loop", {}),
            (["benchmark-mc-reduceblock", "1"], "law",
             dict(terminal_law=True, histogram=False))):
        argv = argv + [str(CLI_MONTHS), str(CLI_PATHS)]
        if key == "law":
            argv.append("--terminal-law")
        with recorded(["run"]) as calls:
            _, counts = counted(lambda: cli(argv))
        check(counts == dict({k: 0 for k in counts}, **{key: n_chunks}),
              f"smmc-torch {' '.join(argv)}: launches {counts}")
        (_, res), = calls
        direct = smt.run(hist_model, CLI_PATHS, CLI_MONTHS,
                         initial_capital=1000.0, seed=0,
                         target_amount=1000.0,
                         options=smt.EngineOptions(**opts))
        check(same_bits(moments_row(res), moments_row(direct)),
              f"smmc-torch {argv[0]}: {moments_row(res)} against the direct "
              f"run's {moments_row(direct)}")
        if res.histogram_counts is not None or \
                direct.histogram_counts is not None:
            check(same_bits(res.histogram_counts, direct.histogram_counts),
                  f"smmc-torch {argv[0]}: histogram differs")
        say(12, f"[{card}] smmc-torch {' '.join(argv)}: {counts[key]} "
                f"launches of {key}, == direct run (n, mean, var, std, min, "
                f"max, skew, kurtosis, count_below, withdrawn: "
                f"{moments_row(res).tolist()}); wall {res.elapsed_s!r} s "
                f"(direct run {direct.elapsed_s!r} s; the reference's RTX "
                f"3070 row {RTX3070_S} s)")

    # 12b. the device mean and the vector add
    (text, counts) = counted(lambda: cli(["benchmark-reduce-mean",
                                          str(CLI_VECTOR)]))
    rel_diff = float(text.split("rel_diff:")[1].split()[0])
    check(rel_diff <= 1e-5 and sum(counts.values()) == 0,
          f"benchmark-reduce-mean: rel_diff {rel_diff}, launches {counts}")
    text, _ = counted(lambda: cli(["demo-vector-add", "--n",
                                   str(CLI_VECTOR)]))
    check(" OK " in text, f"demo-vector-add: {text!r}")
    say(12, f"[{card}] benchmark-reduce-mean {CLI_VECTOR}: rel_diff "
            f"{rel_diff!r}; demo-vector-add {CLI_VECTOR}: OK")

    # 12c. monte-carlo-historical into a temporary directory: the CSVs
    # read back are the run's trajectories at six significant digits
    with tempfile.TemporaryDirectory() as tmp:
        with recorded(["simulate_paths"]) as calls:
            _, counts = counted(lambda: cli([
                "monte-carlo-historical", "1000", str(CLI_MONTHS),
                str(CLI_CSV_PATHS), "--out-dir", tmp]))
        (_, traj), = calls
        check(traj.shape == (CLI_CSV_PATHS, CLI_MONTHS + 1)
              and np.isfinite(traj).all(), f"trajectories {traj.shape}")
        for i in range(CLI_CSV_PATHS):
            _, values = read_data_file(os.path.join(
                tmp, f"historical_{i:05d}.csv"))
            want = np.asarray([float(f"{v:g}") for v in traj[i]],
                              np.float32)
            check(same_bits(values, want),
                  f"historical_{i:05d}.csv differs from the run's row")
    say(12, f"[{card}] monte-carlo-historical 1000 {CLI_MONTHS} "
            f"{CLI_CSV_PATHS}: the CSVs are the run's trajectories; kernel "
            f"launches {sum(counts.values())} (threefry in torch)")

    # 12d. the native library against its Python versions, built into a
    # temporary directory and loaded through $SMMC_NATIVE_LIB, so that no
    # library is left in the checkout to switch later runs' CSV reader
    t = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    lib = native.build(os.path.join(tmp.name, native.LIBRARY.name))
    env_lib = os.environ.get("SMMC_NATIVE_LIB")
    os.environ["SMMC_NATIVE_LIB"] = str(lib)
    native._LIB, native._LOAD_ATTEMPTED = None, False
    check(native.available(), f"native library {lib} does not load")
    got = native.native_read_returns(loader.SYNTHETIC_CSV)
    native._LIB, native._LOAD_ATTEMPTED = None, True
    python = loader.read_historical_returns(loader.SYNTHETIC_CSV)
    native._LIB, native._LOAD_ATTEMPTED = None, False
    check(same_bits(got, python), "native CSV reader != the Python reader")
    rng = np.random.default_rng(0)
    a, b = rng.normal(3, 2, 1000), rng.normal(5, 1, 2345)
    sa = np.asarray([a.size, a.mean(), ((a - a.mean()) ** 2).sum()])
    sb = np.asarray([b.size, b.mean(), ((b - b.mean()) ** 2).sum()])
    merged = native.native_welford_merge(sa.copy(), sb)
    n, mean, m2 = reductions.welford_combine(torch.as_tensor(sa),
                                             torch.as_tensor(sb))
    # the C++ merge adds m2a + (m2b + d^2 w), welford_combine
    # (m2a + m2b) + d^2 w: the same within a few float64 ulps
    python = np.asarray([float(n), float(mean), float(m2)])
    check(merged[0] == python[0]
          and np.allclose(merged, python, rtol=1e-12, atol=0),
          f"native Welford {merged} != welford_combine {python}")
    d = sobol.direction_numbers(7)
    pts = native.native_sobol_points(d, 123457, 64)
    words = sobol.sobol_bits_u32(d, 123457, 64, 7).numpy()
    check(same_bits(pts, words.astype(np.float64) * 2.0**-32),
          "native Sobol points != sobol_bits_u32 * 2^-32")
    if env_lib is None:
        del os.environ["SMMC_NATIVE_LIB"]
    else:
        os.environ["SMMC_NATIVE_LIB"] = env_lib
    native._LIB, native._LOAD_ATTEMPTED = None, False
    tmp.cleanup()
    say(12, f"[{card}] native library built ({lib.name}, "
            f"{time.perf_counter() - t:.1f} s): CSV reader and Sobol points "
            f"== their Python versions, Welford merge within 1e-12")

    # 12e. benchmark-google, then benchmark-compare of the file with itself
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "google.json")
        _, counts = counted(lambda: cli([
            "benchmark-google", str(CLI_MONTHS), str(CLI_GOOGLE_PATHS),
            "--repetitions", "3", "--benchmark-out", out]))
        reps = [b["real_time"] for b in json.load(open(out))["benchmarks"]
                if b.get("run_type") == "iteration"]
        text = cli(["benchmark-compare", out, out])
    row = text.strip().splitlines()[1]
    check(len(reps) == 3 and counts["month_loop"] == 4 and "*" not in row
          and "1.00x" in row, f"benchmark-compare: {row!r}, reps {reps}")
    say(12, f"[{card}] benchmark-google {CLI_MONTHS} {CLI_GOOGLE_PATHS}: "
            f"reps {reps} s, {counts['month_loop']} month-loop launches; "
            f"benchmark-compare: no significant difference ({row.split()[-1]})")

    # 12f. the sweep at full size: every line parses, and it launches the
    # ICDF and Sobol loops, the CLT, both band kernels and the law
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        records, counts = counted(lambda: sweep.main(["--device", "cuda"]))
    wall = time.perf_counter() - t
    lines = out.getvalue().strip().splitlines()
    print(out.getvalue(), end="", flush=True)
    check([json.loads(ln) for ln in lines] == records and len(records) == 9,
          f"sweep: {len(lines)} lines")
    check(all(counts[k] > 0 for k in SWEEP_KERNELS),
          f"sweep: launches {counts}")
    say(12, f"[{card}] sweep (full size) in {wall:.1f} s: {len(records)} "
            f"lines parse; launches "
            f"{ {SWEEP_KERNELS[k]: counts[k] for k in SWEEP_KERNELS} }; "
            + "; ".join(f"{r['metric']} {r['value']!r} paths/s"
                        for r in records))


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------


def main():
    # 1. device
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    from stock_market_monte_carlo_torch.bench import roofline
    from stock_market_monte_carlo_torch.bench.headline import (
        card_line,
        events_ms,
    )

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    say(1, f"device {kind} (count {count}); nvidia-smi: {card}; torch "
           f"{torch.__version__} CUDA {torch.version.cuda}")

    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.ops import _build, clt
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    # 2. build; the month loops', the CLT's and the law's ptxas report: the
    # run kernel's instances (registers, spills; paths a thread, shared
    # memory, window and blocks a SM at the main shapes), the month-loop,
    # CLT and terminal-law kernels' (no spills allowed)
    t = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        path = _build.build(verbose=True)
    print(report.getvalue(), end="")
    _build.load_library()
    say(2, f"built {path.name} in {time.perf_counter() - t:.1f} s")
    from stock_market_monte_carlo_torch.bench import kernel_resources as kres

    res = kres.ptxas_resources(report.getvalue())
    for kernel, instances, params in (
            ("run_loop_kernel", 9, "draw,strategy"),
            ("month_loop_kernel", 6, "draw,strategy"),
            ("clt_kernel", 8, "variant,ablate"),
            ("law_kernel", 2, "finals")):
        found = {args: v for name, v in res.items()
                 if (args := template_args(name, kernel))}
        check(len(found) == instances
              and all(v[1] == v[2] == 0 for v in found.values()),
              f"{kernel} instances (registers, spill stores, spill loads): "
              f"{found}")
        say(2, f"{kernel}<{params}> (registers, spill stores, spill loads): "
               f"{found}")
    plans = {"gaussian": ce.run_kernel_info("gaussian",
                                            n_periods=MAIN_MONTHS)}
    for draw in ("sobol_gaussian", "sobol_historical"):
        for cols, months in ((32, MAIN_MONTHS), (64, MAIN_MONTHS),
                             (64, SOBOL_MONTHS)):
            plans[f"{draw} {cols} columns {months} months"] = \
                ce.run_kernel_info(draw, n_table=1127, dir_cols=cols,
                                   n_periods=months)
    say(2, f"run kernel launch plans (paths a thread, registers, dynamic "
           f"shared memory, window of months, blocks a SM): "
           f"{json.dumps(plans)}")
    from stock_market_monte_carlo_torch.ops import calibration as cal

    # 3. kernels against their plain versions on the card
    hist_model = smt.HistoricalBootstrap.from_csv()
    gauss = smt.GaussianReturns()
    sobol_gauss = smt.SobolGaussianReturns.create(MAIN_MONTHS)
    sobol_hist = smt.SobolHistoricalBootstrap.create(hist_model.returns_pct,
                                                     MAIN_MONTHS)
    reference = smt.HistoricalBootstrap(hist_model.returns_pct,
                                        rng="reference")
    # month-loop kernel -> the model it draws for
    month_models = {"month_loop": hist_model, "month_loop_gaussian": gauss,
                    "month_loop_sobol_gaussian": sobol_gauss,
                    "month_loop_sobol_historical": sobol_hist,
                    "month_loop_reference": reference}
    deep_models = {
        "month_loop_sobol_gaussian": smt.SobolGaussianReturns.create(
            MAIN_MONTHS, index_offset=DEEP_OFFSET),
        "month_loop_sobol_historical": smt.SobolHistoricalBootstrap.create(
            hist_model.returns_pct, MAIN_MONTHS, index_offset=DEEP_OFFSET)}
    schedule = np.random.default_rng(7).uniform(
        0.0, 1.0, MAIN_MONTHS).astype(np.float32)
    strategies = {
        "none": smt.NoWithdrawal(),
        "fixed_percent": smt.FixedPercentWithdrawal(0.4),
        "variable_percent": smt.VariablePercentWithdrawal(schedule),
        "fixed_amount": smt.FixedAmountWithdrawal(5.0),
    }
    # CLT variant -> strategy it runs under in the engine
    clt_cases = {"plain": "none", "keep_fold": "fixed_percent",
                 "prefix": "variable_percent"}
    max_err = dict.fromkeys(KERNELS, 0.0)

    def run_pair(name, label, chunk, plain, ops, kw, finals_rel,
                 plain_kw=None):
        err, r = compare_chunk(label, chunk(*ops, **kw),
                               plain(*ops, **(plain_kw or kw)), kw,
                               finals_rel)
        max_err[name] = max(max_err[name], err)
        how = ("== plain" if finals_rel == 0.0
               else f"matches plain (bar: finals rel {finals_rel})")
        say(3, f"{label}: kernel {how}, finals max abs diff {err}, max rel "
               f"diff {r}")

    for n_periods, valid, n_paths, target in (
            (7, 8192 + 777, 2 * 8192, 1000.0),
            (MAIN_MONTHS, CHECK_PATHS, CHECK_PATHS, 5000.0)):
        for name, model in month_models.items():
            for sname, strategy in strategies.items():
                ops, kw = month_chunk_args(model, strategy, n_periods,
                                           valid, n_paths, target, seed=5)
                run_pair(name, f"{name} {sname} {valid}x{n_periods}",
                         ce.month_loop_chunk, ce.month_loop_chunk_plain,
                         ops, kw, 0.0)
        for variant, sname in clt_cases.items():
            ops, kw = clt_chunk_args(variant, strategies[sname], n_periods,
                                     valid, n_paths, target, seed=5)
            run_pair("clt", f"clt {variant} {valid}x{n_periods}",
                     clt.clt_chunk, clt.clt_chunk_plain, ops, kw, CLT_REL)
    # the Sobol draws at 64-bit positions (index_offset 2^33 + 777, not a
    # multiple of the kernel's 8 or 16 paths a thread), under every strategy
    for name, model in deep_models.items():
        for sname in strategies:
            ops, kw = month_chunk_args(model, strategies[sname], MAIN_MONTHS,
                                       CHECK_PATHS, CHECK_PATHS, 5000.0,
                                       seed=5)
            run_pair(name, f"{name} deep index_offset={DEEP_OFFSET} {sname} "
                           f"{CHECK_PATHS}x{MAIN_MONTHS}",
                     ce.month_loop_chunk, ce.month_loop_chunk_plain, ops, kw,
                     0.0)
    for keep_finals in (True, False):
        ops, kw = law_chunk_args(hist_model, MAIN_MONTHS, CHECK_PATHS,
                                 CHECK_PATHS, 5000.0, seed=9,
                                 keep_finals=keep_finals)
        run_pair("law", f"law finals={keep_finals} {CHECK_PATHS}x{MAIN_MONTHS}",
                 ce.law_chunk, ce.law_chunk_plain, ops, kw, 0.0,
                 plain_kw=dict(kw, keep_finals=True))
    # ... and at the main paths' own chunks: the first, and the ragged
    # last one at its own tile offset (seed 0, target 2000); the Sobol
    # draws also at 64-bit positions
    n_chunks = -(-MAIN_PATHS // CHUNK)
    last = (n_chunks - 1) * CHUNK
    for first, valid in ((0, CHUNK), (last, MAIN_PATHS - last)):
        finals = first != 0
        tile0 = first // ce.TILE_PATHS
        for name, model in (*month_models.items(), *deep_models.items()):
            ops, kw = month_chunk_args(model, smt.NoWithdrawal(),
                                       MAIN_MONTHS, valid, CHUNK, 2000.0,
                                       seed=0, tile0=tile0)
            run_pair(name, f"{name} main chunk tile0={tile0} valid={valid} "
                           f"index_offset={getattr(model, 'index_offset', 0)}",
                     ce.month_loop_chunk, ce.month_loop_chunk_plain, ops,
                     dict(kw, keep_finals=finals), 0.0, plain_kw=kw)
        ops, kw = law_chunk_args(hist_model, MAIN_MONTHS, valid, CHUNK,
                                 2000.0, seed=0, keep_finals=finals,
                                 tile0=tile0)
        run_pair("law", f"law main chunk tile0={tile0} valid={valid}",
                 ce.law_chunk, ce.law_chunk_plain, ops, kw, 0.0,
                 plain_kw=dict(kw, keep_finals=True))
        for variant in ("plain", "prefix"):
            tile0 = first // clt.tile_paths(variant)
            ops, kw = clt_chunk_args(
                variant, strategies[clt_cases[variant]], MAIN_MONTHS, valid,
                CHUNK, 2000.0, seed=0, tile0=tile0)
            run_pair("clt",
                     f"clt {variant} main chunk tile0={tile0} valid={valid}",
                     clt.clt_chunk, clt.clt_chunk_plain, ops,
                     dict(kw, keep_finals=finals), CLT_REL, plain_kw=kw)

    # 3a. the historical month loop's warp items: chunks whose valid paths
    # end inside a 256-path item, at tile0 37, under three strategies, at
    # 4, 8 and 16 blocks a SM, binned in place (4096 cells) and by the
    # histogram kernel (102); bit for bit. The CLT at 2, 3 and 4 blocks a
    # SM: the same finals, counts and histogram. The CLT's finish against
    # its twin (clt.finals_twin) bit for bit, where both sides' products
    # are exact: the production variants at rows of products from 1e-6 to
    # 8 (cs = 0), the nomm probe on the stream's rows.
    n_items = 0
    for valid in PARTIAL_ITEMS:
        for sname in ("none", "fixed_percent", "fixed_amount"):
            for bins in (4094, 100):
                ops, kw = month_chunk_args(hist_model, strategies[sname],
                                           MAIN_MONTHS, valid, 3 * 8192,
                                           1500.0, seed=5, tile0=37,
                                           bins=bins)
                plain = ce.month_loop_chunk_plain(*ops, **kw)
                for bps in ((4, 8, 16) if bins == 4094 else (None,)):
                    launch, outputs = ce.month_loop_launcher(
                        *ops, **kw, blocks_per_sm=bps)
                    launch()
                    compare_chunk(f"month_loop items valid={valid} {sname} "
                                  f"{bins} bins {bps} blocks a SM",
                                  outputs(), plain, kw, 0.0)
                    n_items += 1
    say("3a", f"month_loop at partial items {PARTIAL_ITEMS} x 3 strategies x "
              f"(4096 cells at 4, 8, 16 blocks a SM; 102 cells): {n_items} "
              "chunks == plain")
    for variant, sname in clt_cases.items():
        ops, kw = clt_chunk_args(variant, strategies[sname], MAIN_MONTHS,
                                 CHECK_PATHS + 1001, CHECK_PATHS + 8192,
                                 2000.0, seed=5, tile0=3)
        outs = []
        for bps in (2, 3, 4):
            launch, outputs = clt.clt_launcher(*ops, **kw, blocks_per_sm=bps)
            launch()
            outs.append(outputs())
        torch.cuda.synchronize()
        (s0, h0, f0), rels = outs[0], []
        for sk, hk, fk in outs[1:]:
            check(torch.equal(fk, f0) and torch.equal(hk, h0)
                  and torch.equal(sk[[0, 5, 6, 7]], s0[[0, 5, 6, 7]]),
                  f"clt {variant}: results depend on the grid")
            rels.append(float(((sk - s0).abs() / s0.abs().clamp_min(
                1e-30)).max()))
        say("3a", f"clt {variant} at 2, 3, 4 blocks a SM: finals, histogram, "
                  f"counts, min, max equal; stats rel {rels}")
    q = clt.q_tensor(DEVICE)
    nblocks = -(-MAIN_MONTHS // clt.CLT_K)
    logs = np.random.default_rng(11).normal(0.015, 0.08, clt.CLT_K)
    logs[:3], logs[-3:] = -13.8, 2.08
    arow = torch.as_tensor(np.broadcast_to(np.exp(logs / nblocks).astype(
        np.float32), (nblocks, clt.CLT_K)).copy(), device=DEVICE)
    zero = torch.zeros_like(arow)
    rows = torch.arange(CHECK_PATHS, device=DEVICE)
    for variant in ("plain", "keep_fold"):
        kw = dict(_common(gauss, strategies["none"], MAIN_MONTHS, CHECK_PATHS,
                          CHECK_PATHS, 2000.0, 0),
                  variant=variant, seed_base=0x11C7)
        fk = clt.clt_chunk(q, arow, zero, None, **kw)[2]
        twin = clt.finals_twin(clt.row_products(
            q, arow, zero, seed_base=0x11C7, tile0=0, rows=rows), 1000.0)
        torch.cuda.synchronize()
        check(torch.equal(fk, twin), f"clt {variant}: finish differs from "
              f"its twin (max {float((fk - twin).abs().max())})")
    from stock_market_monte_carlo_torch.bench import probes

    ops, kw = probes.clt_probe_case(CHECK_PATHS, DEVICE, probes.ABLATE_SEED)
    kw = dict(kw, ablate="nomm", keep_finals=True)
    fk = clt.clt_probe_chunk(*ops, **kw)[2]
    twin = clt.finals_twin(clt.row_products(
        *ops, seed_base=kw["seed_base"], tile0=kw["tile0"],
        rows=torch.arange(kw["valid"], device=DEVICE), ablate="nomm"),
        kw["v0"], "nomm")
    torch.cuda.synchronize()
    check(torch.equal(fk, twin), "clt_probe nomm: finish differs from its "
          f"twin (max {float((fk - twin).abs().max())})")
    say("3a", f"clt finish == its twin bit for bit: plain and keep_fold "
              f"{CHECK_PATHS} x {MAIN_MONTHS} at products 1e-6 .. 8 (cs = 0), "
              f"nomm probe {kw['valid']} x {probes.CLT_MONTHS}")

    # 3b. the band kernels against their plain versions, bit for bit: both
    # draws, with and without a percent strategy, at 2^20 x 360 and at the
    # first and the ragged last chunk of a 100M run
    from stock_market_monte_carlo_torch.ops import bands as bk

    band_fns = {"bands_hist": ("hist", bk.month_hist_chunk,
                               bk.month_hist_chunk_plain),
                "bands_cdf": ("cdf", bk.month_cdf_chunk,
                              bk.month_cdf_chunk_plain)}
    for valid, n_paths, tile0 in ((CHECK_PATHS, CHECK_PATHS, 0),
                                  (CHUNK, CHUNK, 0),
                                  (MAIN_PATHS - last, CHUNK,
                                   last // ce.TILE_PATHS)):
        for model in (hist_model, gauss):
            for sname in ("none", "fixed_percent"):
                for name, (reduce_kind, chunk, plain) in band_fns.items():
                    ops, kw = band_chunk_args(model, strategies[sname],
                                              reduce_kind, MAIN_MONTHS,
                                              valid, n_paths, seed=0,
                                              tile0=tile0)
                    label = (f"{name} {model.kind} {sname} valid={valid} "
                             f"tile0={tile0}")
                    err = compare_counts(label, chunk(*ops, **kw),
                                         plain(*ops, **kw), reduce_kind,
                                         valid)
                    max_err[name] = max(max_err[name], err)
                    say("3b", f"{label}: kernel == plain")
    # ... and at adversarial inputs, bit for bit, in a chunk whose last
    # tile holds one path: the counts below thresholds at B_t = 1e-7 about
    # the month's centre (thresholds tied in float32, the guess off by
    # many cells) and at B_t = 10 (thresholds past float32: +inf above, 0
    # below); both kernels on the hostile 97-row table, with a withdrawal
    # of 60 % a month that takes every path through the denormals to 0
    from stock_market_monte_carlo_torch.data.loader import (
        HOSTILE_CSV,
        read_historical_returns,
    )

    hostile = smt.HistoricalBootstrap(read_historical_returns(HOSTILE_CSV))
    depleting = smt.VariablePercentWithdrawal(
        np.full(MAIN_MONTHS, 60.0, np.float32))
    valid = CHECK_PATHS - ce.TILE_PATHS + 1
    for mname, model, strategy, reduce_kind, b_t in (
            ("gaussian", gauss, strategies["none"], "cdf", 1e-7),
            ("gaussian", gauss, strategies["none"], "cdf", 10.0),
            ("hostile_n97", hostile, strategies["fixed_percent"], "cdf",
             None),
            ("hostile_n97", hostile, depleting, "cdf", None),
            ("hostile_n97", hostile, depleting, "hist", None)):
        name, chunk, plain = {"hist": ("bands_hist", bk.month_hist_chunk,
                                       bk.month_hist_chunk_plain),
                              "cdf": ("bands_cdf", bk.month_cdf_chunk,
                                      bk.month_cdf_chunk_plain)}[reduce_kind]
        ops, kw = band_chunk_args(model, strategy, reduce_kind, MAIN_MONTHS,
                                  valid, CHECK_PATHS, seed=3, tile0=3)
        what = f"{strategy.kind} grid"
        if b_t is not None:
            from stock_market_monte_carlo_torch.engine import bands as be

            centers, _ = be.band_grid(model, strategy, MAIN_MONTHS, 1000.0)
            ca = centers[1:].astype(np.float32)
            cb = np.full(MAIN_MONTHS, b_t, np.float32)
            ops = (*ops[:2], torch.as_tensor(ca, device=DEVICE),
                   torch.as_tensor(cb, device=DEVICE))
            kw = dict(kw, coef_b_host=cb)
            what = f"A_t the centres, B_t = {b_t}"
        label = f"{name} {mname} {what} valid={valid}"
        err = compare_counts(label, chunk(*ops, **kw), plain(*ops, **kw),
                             reduce_kind, valid)
        max_err[name] = max(max_err[name], err)
        say("3b", f"{label}: kernel == plain")
    # the band histogram at 20003 cells (two months a window) on both draws
    for model in (hist_model, gauss):
        ops, kw = band_chunk_args(model, strategies["fixed_percent"], "hist",
                                  MAIN_MONTHS, valid, CHECK_PATHS, seed=3,
                                  tile0=3, n_bins=BAND_ODD_BINS)
        label = f"bands_hist {model.kind} {BAND_ODD_BINS + 2} cells"
        err = compare_counts(label, bk.month_hist_chunk(*ops, **kw),
                             bk.month_hist_chunk_plain(*ops, **kw), "hist",
                             valid)
        max_err["bands_hist"] = max(max_err["bands_hist"], err)
        say("3b", f"{label} valid={valid}: kernel == plain")
    # what the band kernels launch for a main chunk
    plans = {}
    for model in (hist_model, gauss):
        _, draw = ce.draw_operands(model, DEVICE)
        for mode, (name, cells) in enumerate((("bands_hist", BAND_BINS + 2),
                                              ("bands_cdf",
                                               BAND_THRESHOLDS))):
            plans[f"{name} {model.kind}"] = bk.kernel_info(
                mode, draw["draw"], keep=False,
                n_table=draw.get("n_table", 0), n_periods=MAIN_MONTHS,
                valid=CHUNK, n_cells=cells)
    say("3b", f"launch plans at {CHUNK} x {MAIN_MONTHS} (registers a "
              f"thread, shared memory, threads a block, resident blocks a "
              f"SM, grid, copies of the count table, months a window, "
              f"windows): {json.dumps(plans)}")

    # 3c. the headline's calibration kernels and the counts below a tile
    # against their plain versions, bit for bit: the grid overhead at the
    # 2^24-path shape, both variants, 1 and 16 tiles a block (and group 1
    # == group 16); the calibration pair at 2^24 x 360 and at a ragged tile
    # offset; the counts below a tile with ties, K = 8, 32, 64
    n_tiles = CHUNK // ce.TILE_PATHS
    for variant in cal.VARIANTS:
        outs = {}
        for group in (1, 16):
            kw = dict(seed=GRID_SEED, n_tiles=n_tiles, device=DEVICE)
            got = cal.grid_overhead_chunk(variant, group, **kw)
            want = cal.grid_overhead_chunk_plain(variant, group, **kw)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"grid_overhead {variant} group {group}: kernel differs "
                  f"from plain by {err}")
            max_err["grid_overhead"] = max(max_err["grid_overhead"], err)
            outs[group] = got
        check(all(torch.equal(a, b) for a, b in zip(outs[1], outs[16])),
              f"grid_overhead {variant}: group 1 and group 16 differ")
        say("3c", f"grid_overhead {variant} {n_tiles} tiles, 1 and 16 a "
                  "block: kernel == plain, group 1 == group 16")
    for n_ops in cal.CALIB_OPS:
        for n_paths, tile0 in ((CHUNK, 0),
                               (CHECK_PATHS + 3 * ce.TILE_PATHS,
                                CALIB_TILE0)):
            kw = dict(n_periods=MAIN_MONTHS, n_paths=n_paths,
                      seed=CALIB_SEED + tile0, device=DEVICE)
            got = cal.calib_chunk(n_ops, **kw)
            want = cal.calib_chunk_plain(n_ops, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(torch.equal(got, want) and bool(torch.isfinite(got).all()),
                  f"calib n_ops={n_ops} tile0={tile0}: kernel differs from "
                  f"plain by {err}")
            max_err["calib"] = max(max_err["calib"], err)
            say("3c", f"calib n_ops={n_ops} {n_paths} x {MAIN_MONTHS} "
                      f"tile0={tile0}: kernel == plain (checksum "
                      f"{float(got.double().sum())!r})")
    rng = np.random.default_rng(11)
    tile = np.exp(rng.normal(size=(ce.TILE_ROWS, 128)).astype(np.float32))
    for k in COUNTS_K:
        thr = np.exp(rng.normal(size=(k, 128)).astype(np.float32))
        thr[k // 2] = tile[3]   # ties: strictly below excludes them
        ops = (torch.as_tensor(tile, device=DEVICE),
               torch.as_tensor(thr, device=DEVICE))
        got = bk.counts_below_tile(*ops)
        want = bk.counts_below_tile_plain(*ops)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(torch.equal(got, want), f"counts_below_tile K={k}: kernel "
                                      f"differs from plain by {err}")
        max_err["counts_below_tile"] = max(max_err["counts_below_tile"], err)
        say("3c", f"counts_below_tile K={k}, ties in row {k // 2}: kernel "
                  "== plain")

    # 3d. the histogram kernel's three modes against their plain versions
    # and np.bincount, bit for bit, at 2^24 inputs and each cell count; the
    # tile flatten against arange; the CLT and law chunks of an odd
    # histogram (cells not a multiple of 64: the finals through the
    # histogram kernel) against their plain versions; the Sobol draws at
    # the table's 1866 months with 64-bit positions (direction rows read
    # from global memory) against their plain versions
    from stock_market_monte_carlo_torch.ops import histogram

    rng_h = np.random.default_rng(21)
    for hb in HIST_CELLS:
        spec = eng_spec(hist_model, MAIN_MONTHS, hb - 2)
        inputs = hist_inputs(rng_h, hb, spec)
        for mode, (x, kw) in inputs.items():
            got = histogram.histogram_counts(x, hb, mode=mode, **kw)
            want = histogram.histogram_plain(x, hb, mode=mode, **kw)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            check(got.dtype == torch.int32 and torch.equal(got, want),
                  f"histogram {mode} {hb} cells: kernel differs from plain "
                  f"by {err}")
            bins = hist_bins(histogram, mode, x, hb, kw)
            check(np.array_equal(got.cpu().numpy(),
                                 np.bincount(bins, minlength=hb)),
                  f"histogram {mode} {hb} cells: differs from np.bincount")
            name = {"spec": "histogram"}.get(mode, f"histogram_{mode}")
            max_err[name] = max(max_err[name], err)
            say("3d", f"histogram {mode} {CHUNK} inputs, {hb} cells: kernel "
                      f"== plain == np.bincount (mass {int(got.sum())})")
    tiles = torch.arange(CHUNK, dtype=torch.float32, device=DEVICE).reshape(
        -1, 128)
    got = histogram.flatten_tile(tiles)
    torch.cuda.synchronize()
    check(got.shape == (CHUNK, 1)
          and torch.equal(got, histogram.flatten_tile_plain(tiles))
          and torch.equal(got[:, 0], torch.arange(CHUNK, dtype=torch.float32,
                                                  device=DEVICE)),
          "flatten_tile: row-major order not kept")
    say("3d", f"flatten_tile {CHUNK // ce.TILE_PATHS} tiles: kernel == plain "
              "== arange (row-major order kept)")
    for odd_tiles in FLATTEN_ODD_TILES:
        odd = tiles[:odd_tiles * ce.TILE_ROWS]
        check(torch.equal(histogram.flatten_tile(odd),
                          histogram.flatten_tile_plain(odd)),
              f"flatten_tile {odd_tiles} tiles: kernel differs from plain")
    say("3d", f"flatten_tile {FLATTEN_ODD_TILES} tiles: kernel == plain")
    ops, kw = law_chunk_args(hist_model, MAIN_MONTHS, CHECK_PATHS,
                             CHECK_PATHS, 5000.0, seed=9, keep_finals=True,
                             bins=ODD_BINS)
    run_pair("law", f"law {ODD_BINS + 2} cells {CHECK_PATHS}x{MAIN_MONTHS}",
             ce.law_chunk, ce.law_chunk_plain, ops, kw, 0.0)
    ops, kw = clt_chunk_args("plain", strategies["none"], MAIN_MONTHS,
                             CHECK_PATHS, CHECK_PATHS, 5000.0, seed=5,
                             bins=ODD_BINS)
    run_pair("clt", f"clt plain {ODD_BINS + 2} cells "
                    f"{CHECK_PATHS}x{MAIN_MONTHS}",
             clt.clt_chunk, clt.clt_chunk_plain, ops, kw, CLT_REL)
    long_models = {
        "month_loop_sobol_gaussian": smt.SobolGaussianReturns.create(
            SOBOL_MONTHS, index_offset=DEEP_OFFSET),
        "month_loop_sobol_historical": smt.SobolHistoricalBootstrap.create(
            hist_model.returns_pct, SOBOL_MONTHS, index_offset=DEEP_OFFSET)}
    long_strategies = dict(strategies, variable_percent=(
        smt.VariablePercentWithdrawal(np.random.default_rng(7).uniform(
            0.0, 1.0, SOBOL_MONTHS).astype(np.float32))))
    for name, model in long_models.items():
        for sname in strategies:
            ops, kw = month_chunk_args(model, long_strategies[sname],
                                       SOBOL_MONTHS, 3 * ce.TILE_PATHS + 5,
                                       4 * ce.TILE_PATHS, 5000.0, seed=5,
                                       tile0=11)
            run_pair(name, f"{name} {SOBOL_MONTHS} months index_offset="
                           f"{DEEP_OFFSET} {sname}",
                     ce.month_loop_chunk, ce.month_loop_chunk_plain, ops, kw,
                     0.0)

    # 3e. the experiment probes against their plain versions: the toys at
    # the 4096 tiles the timings and the report run (bit for bit, mm within MM_ROW_REL of a row's scale); each
    # CLT ablation at 2^24 x 360 with exp_clt_ablate.py's inputs, and the
    # tile groupings with exp_clt_ts2.py's (at the CLT's bar, counts exact
    # but for finals on an edge; every grouping bit-identical to the
    # stride in finals, histogram, count, min and max); the byte planes of
    # both experiments' seeds against the plain version and the counter
    # words; the production CLT's SASS against the parent build's
    from stock_market_monte_carlo_torch.bench import probes
    from stock_market_monte_carlo_torch.ops import byte_planes as bp

    for op in cal.TOY_OPS:
        got = cal.op_toy_chunk(op, cal.TOY_TILES, device=DEVICE)
        want = cal.op_toy_chunk_plain(op, cal.TOY_TILES,
                                     device=DEVICE)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if op == "mm":
            scale = want.abs().amax(dim=1, keepdim=True)
            spread = float(((got - want).abs() / scale).max())
            check(spread <= MM_ROW_REL and bool(torch.isfinite(got).all()),
                  f"op_toy mm: kernel differs from plain by {spread} of a "
                  "row's scale")
            equal = float((got == want).double().mean())
            how = (f"matches plain within {MM_ROW_REL} of a row's scale "
                   f"(largest {spread!r}, {equal!r} of the elements equal)")
        else:
            check(torch.equal(got, want),
                  f"op_toy {op}: kernel differs from plain by {err}")
            how = "== plain"
        max_err[f"op_toy_{op}"] = err
        say("3e", f"op_toy {op} {cal.TOY_TILES} tiles: kernel {how}")
    for ablate in clt.ABLATIONS:
        ops, kw = probes.clt_probe_case(CHUNK, DEVICE, probes.ABLATE_SEED)
        kw = dict(kw, ablate=ablate, keep_finals=True)
        err, r, exact = compare_probe(
            f"clt_probe {ablate}", clt.clt_probe_chunk(*ops, **kw),
            clt.clt_probe_chunk_plain(*ops, **kw), kw)
        max_err[f"clt_probe_{ablate}"] = err
        counts = "exact" if exact else "within the edge allowance"
        say("3e", f"clt_probe {ablate} {CHUNK} x {probes.CLT_MONTHS}: "
                  f"kernel matches plain (bar: finals rel {CLT_REL}), "
                  f"finals max abs diff {err}, max rel diff {r}; count "
                  f"below and histogram {counts}")
    ops, kw = probes.clt_probe_case(CHUNK, DEVICE, probes.GROUPING_SEED)
    kw = dict(kw, ablate="base", keep_finals=True)
    plain = clt.clt_probe_chunk_plain(*ops, **kw)
    stride = clt.clt_probe_chunk(*ops, tiles_per_block=0, **kw)
    compare_probe("clt_probe base ts=0", stride, plain, kw)
    for ts in clt.GROUPINGS[1:]:
        out = clt.clt_probe_chunk(*ops, tiles_per_block=ts, **kw)
        err, r, _ = compare_probe(f"clt_probe base ts={ts}", out, plain, kw)
        (s1, h1, f1), (s0, h0, f0) = out, stride
        check(torch.equal(f1, f0) and torch.equal(h1, h0)
              and torch.equal(s1[[0, 5, 6, 7]], s0[[0, 5, 6, 7]]),
              f"clt_probe ts={ts}: differs from the stride")
        sums = float(((s1[1:5] - s0[1:5]).abs() / s0[1:5].abs()).max())
        check(sums <= 1e-12, f"clt_probe ts={ts}: power sums rel {sums}")
        max_err[f"clt_probe_ts{ts}"] = err
        say("3e", f"clt_probe base {ts} tiles a block, {CHUNK} x "
                  f"{probes.CLT_MONTHS}: finals, histogram, count, min and "
                  f"max == the stride's; power sums within {sums!r}; vs "
                  f"plain max rel {r}")
    for name, seeds in (("byte_planes", bp.BYTES_SEEDS),
                        ("byte_planes_crossword", bp.CROSSWORD_SEEDS)):
        got = bp.byte_planes(seeds, device=DEVICE)
        want = bp.byte_planes_plain(seeds, device=DEVICE)
        torch.cuda.synchronize()
        b = got.reshape(len(seeds), 4, -1).long()
        words = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
        s_t = torch.as_tensor(np.asarray(seeds, np.int64), device=DEVICE)
        counter = ce._arith_bits(s_t[:, None], 0,
                                 torch.arange(bp.WORDS, device=DEVICE))
        check(torch.equal(got, want) and torch.equal(words, counter),
              f"{name}: kernel differs from plain or the counter words")
        say("3e", f"{name} {len(seeds)} seeds: kernel == plain, bytes == "
                  "the counter words (_arith_bits, key 0)")
    stats = probes.byte_stats(bp.byte_planes(bp.BYTES_SEEDS,
                                             device=DEVICE).cpu().numpy())
    off = np.abs(np.asarray(stats["byte_corr"]) - np.eye(4)).max()
    check(all(abs(m - 127.5) <= BYTE_MEAN_TOL for m in stats["byte_means"])
          and off < BYTE_CORR_MAX
          and abs(stats["corr_lo16_hi16"]) < BYTE_CORR_MAX,
          f"byte planes: {stats}")
    say("3e", f"byte planes, {stats['n_words']} words: means "
              f"{stats['byte_means']}, largest off-diagonal |corr| {off!r}, "
              f"corr(lo16, hi16) {stats['corr_lo16_hi16']!r}")
    sass = cal.clt_production_sass()
    check(sass == CLT_SASS_PARENT,
          f"production CLT SASS {sass} vs the pinned {CLT_SASS_PARENT}")
    say("3e", f"production CLT SASS instructions {sass} == the pinned "
              f"build's {CLT_SASS_PARENT}")

    # 4. goldens on the card
    f = smt.simulate_final_values(
        hist_model, GOLDEN_N, GOLDEN["t"], seed=12,
        options=smt.EngineOptions(chunk_paths=8192))
    check(np.array_equal(f[:4], np.float32(GOLDEN["head"])),
          f"golden head {f[:4]}")
    for idx, val in GOLDEN["probes"].items():
        check(f[idx] == np.float32(val), f"golden probe {idx}: {f[idx]}")
    total = float(np.sum(f, dtype=np.float64))
    check(rel(total, GOLDEN["total"]) <= 1e-12, f"golden total {total}")
    say(4, f"historical golden bit-exact on the card (total {total!r})")
    f = smt.simulate_final_values(
        gauss, GOLDEN_N, GOLDEN_CLT["t"], seed=12,
        options=smt.EngineOptions(chunk_paths=8192, gaussian_sampler="clt"))
    errs = [rel(float(a), b) for a, b in zip(f[:4], GOLDEN_CLT["head"])]
    errs += [rel(float(f[i]), v) for i, v in GOLDEN_CLT["probes"].items()]
    total = float(np.sum(f, dtype=np.float64))
    errs.append(rel(total, GOLDEN_CLT["total"]))
    check(max(errs) <= GOLDEN_CLT_REL, f"CLT golden rel errors {errs}")
    say(4, f"CLT golden on the card within {GOLDEN_CLT_REL} (max rel "
           f"{max(errs)!r}, total {total!r})")

    # 5. the main paths, each counted on its own
    g_hist = 1.0 + float(np.mean(hist_model.returns_pct.astype(np.float64))
                         ) / 100.0
    g_gauss = 1.0 + float(gauss.mean_pct) / 100.0
    main_paths = {
        # kernel key: (label, model, options, analytic mean)
        "month_loop": ("historical month loop", hist_model, {}, g_hist),
        "law": ("terminal law", hist_model, dict(terminal_law=True), g_hist),
        "month_loop_gaussian": ("Gaussian ICDF month loop", gauss, {},
                                g_gauss),
        "clt": ("Gaussian CLT", gauss, dict(gaussian_sampler="clt"),
                g_gauss),
        "month_loop_sobol_gaussian": ("Sobol Gaussian month loop",
                                      sobol_gauss, {}, g_gauss),
        "month_loop_sobol_historical": ("Sobol historical month loop",
                                        sobol_hist, {}, g_hist),
        "month_loop_reference": ("reference-parity historical month loop",
                                 reference, {}, g_hist),
    }

    def main_run(key):
        _, model, opts, _ = main_paths[key]
        return smt.simulate_stats(model, MAIN_PATHS, MAIN_MONTHS,
                                  target_amount=2000.0,
                                  options=smt.EngineOptions(**opts))

    launches = {}
    main_results = {}
    for key, (label, _, _, g_bar) in main_paths.items():
        ce.reset_launch_counts()
        res = main_results[key] = main_run(key)
        torch.cuda.synchronize()
        counts = dict(ce.LAUNCHES)
        launches[key] = counts[key]
        want = dict({k: 0 for k in counts}, **{key: n_chunks})
        check(counts == want, f"{label}: launches {counts}")
        check(res.moments.n == MAIN_PATHS, f"{label}: n {res.moments.n}")
        mass = float(res.histogram_counts.sum())
        check(mass == MAIN_PATHS, f"{label}: histogram mass {mass}")
        analytic = 1000.0 * g_bar ** MAIN_MONTHS
        dev = abs(res.mean / analytic - 1.0)
        check(np.isfinite(res.mean) and dev < 1e-3,
              f"{label}: mean {res.mean} vs analytic {analytic}")
        say(5, f"{label} 100M x 360: {counts[key]} launches of {key}, mass "
               f"{MAIN_PATHS}, mean {res.mean!r} (analytic {analytic!r}, "
               f"rel dev {dev:.2e}), std {res.std!r}, count_below "
               f"{res.count_below}")

    # 5d. the historical month loop at 100M x 360 with a 20000-bin
    # histogram, counted on its own: the kernel writes each chunk's finals
    # and the histogram kernel counts them; the statistics come from the
    # same kernel as the default run's, so they are the default run's
    def big_hist_run():
        return smt.simulate_stats(
            hist_model, MAIN_PATHS, MAIN_MONTHS, target_amount=2000.0,
            options=smt.EngineOptions(histogram_bins=BIG_BINS))

    ce.reset_launch_counts()
    res = big_hist_run()
    torch.cuda.synchronize()
    counts = dict(ce.LAUNCHES)
    launches["histogram"] = counts["histogram"]
    want = dict({k: 0 for k in counts}, month_loop=n_chunks,
                histogram=n_chunks)
    check(counts == want, f"{BIG_BINS}-bin run: launches {counts}")
    h = res.histogram_counts
    check(h.shape == (BIG_BINS + 2,) and float(h.sum()) == MAIN_PATHS,
          f"{BIG_BINS}-bin run: histogram {h.shape}, mass {float(h.sum())}")
    base = main_results["month_loop"]
    check(res.mean == base.mean and res.std == base.std
          and res.count_below == base.count_below,
          f"{BIG_BINS}-bin run: mean {res.mean} std {res.std} vs the "
          f"default run's {base.mean} {base.std}")
    say("5d", f"historical month loop 100M x 360, {BIG_BINS} bins: "
              f"{counts['month_loop']} launches of month_loop, "
              f"{counts['histogram']} of histogram, mass {MAIN_PATHS} in "
              f"{BIG_BINS + 2} cells ({int((h > 0).sum())} non-empty), mean "
              f"{res.mean!r} == the 4094-bin run's")

    # 5a. replicated RQMC: 8 digital shifts of 2^24 Sobol Gaussian points,
    # beside 8 seeds of the pseudo-random Gaussian model; the 99 % interval
    # must hold the analytic mean. Each replicate is unbiased for the mean
    # of the model as the kernels sample it, whose growth constant is the
    # float32 a = 1 + mean * 0.01 (1.0049999952 for 1.005): E[V_T] =
    # 1000 * a^360, 1.7e-6 below 1000 * 1.005^360 and far outside an
    # interval of RQMC's width.
    a32 = ce.gaussian_ab(sobol_gauss.mean_pct, sobol_gauss.std_pct)[0]
    analytic = 1000.0 * a32 ** MAIN_MONTHS
    est = {}
    for label, model in (("Sobol Gaussian", sobol_gauss),
                         ("GaussianReturns", gauss)):
        ce.reset_launch_counts()
        est[label] = smt.rqmc_estimate(model, RQMC_PATHS, MAIN_MONTHS,
                                       replicates=RQMC_REPLICATES,
                                       confidence=0.99)
        torch.cuda.synchronize()
        key = ("month_loop_sobol_gaussian" if model.is_quasi
               else "month_loop_gaussian")
        check(ce.LAUNCHES[key] == RQMC_REPLICATES,
              f"rqmc {label}: launches {ce.LAUNCHES}")
    e = est["Sobol Gaussian"]
    check(e.ci_lo <= analytic <= e.ci_hi,
          f"rqmc: 99 % interval [{e.ci_lo}, {e.ci_hi}] misses {analytic}")
    say("5a", f"rqmc_estimate Sobol Gaussian {RQMC_REPLICATES} x "
              f"{RQMC_PATHS} x {MAIN_MONTHS}: mean {e.mean!r}, 99 % interval "
              f"[{e.ci_lo!r}, {e.ci_hi!r}] holds the analytic {analytic!r} "
              f"(1000 * {a32!r}^{MAIN_MONTHS}; at 1.005 exactly "
              f"{1000.0 * g_gauss ** MAIN_MONTHS!r}); "
              f"sem {e.sem!r} vs {est['GaussianReturns'].sem!r} for "
              f"GaussianReturns (ratio "
              f"{est['GaussianReturns'].sem / e.sem:.3g})")

    # 5b. bands at 100M x 360, each counted on its own
    from stock_market_monte_carlo_torch.ops import analytic as ana

    band_paths = {
        # kernel key: (label, model, simulate_bands keywords)
        "bands_hist": ("historical bands (hist)", hist_model,
                       dict(band_mode="hist", n_bins=BAND_BINS)),
        "bands_cdf": ("Gaussian bands (cdf)", gauss,
                      dict(band_mode="cdf", n_thresholds=BAND_THRESHOLDS)),
    }
    qs = BAND_QS

    def exact_marginals(model):
        if model.kind == "gaussian":
            return ana.marginal_value_quantiles(
                "gaussian", (model.mean_pct, model.std_pct), MAIN_MONTHS,
                1000.0, qs)
        return ana.marginal_value_quantiles(
            "bootstrap", model.returns_pct.astype(np.float64), MAIN_MONTHS,
            1000.0, qs)

    def band_run(key):
        _, model, kw = band_paths[key]
        return smt.simulate_bands(model, MAIN_PATHS, MAIN_MONTHS,
                                  quantile_levels=qs, sample_paths=32, **kw)

    band_results = {}
    for key, (label, model, kw) in band_paths.items():
        ce.reset_launch_counts()
        res = band_results[key] = band_run(key)
        torch.cuda.synchronize()
        counts = dict(ce.LAUNCHES)
        launches[key] = counts[key]
        want = dict({k: 0 for k in counts}, **{key: n_chunks})
        check(counts == want, f"{label}: launches {counts}")
        mh = res.month_hist
        if kw["band_mode"] == "hist":
            check(bool((mh.sum(axis=1) == MAIN_PATHS).all()),
                  f"{label}: month masses {mh.sum(axis=1)}")
            mass = "every month's histogram holds 1e8 paths"
        else:
            # every path lies between the -14 and +14 sigma guards
            check(bool((mh[:, -1] == MAIN_PATHS).all()
                       and (mh[:, 0] == 0).all()
                       and (np.diff(mh, axis=1) >= 0).all()),
                  f"{label}: guard counts {mh[:, 0]} {mh[:, -1]}")
            mass = "every month's 1e8 paths between the guards"
        exact = exact_marginals(model)
        devs = [rel(res.values[1, t], exact[1, t]) for t in BAND_MONTHS]
        check(max(devs) <= BAND_MEDIAN_REL,
              f"{label}: median vs exact marginal rel {devs}")
        check(res.sample_paths.shape == (32, MAIN_MONTHS + 1)
              and np.isfinite(res.sample_paths).all(),
              f"{label}: sample paths {res.sample_paths.shape}")
        say("5b", f"{label} 100M x 360: {counts[key]} launches of {key}, "
                  f"{mass}; median at months {BAND_MONTHS}: "
                  f"{[float(res.values[1, t]) for t in BAND_MONTHS]} vs "
                  f"exact {[float(exact[1, t]) for t in BAND_MONTHS]} "
                  f"(rel {devs})")
    # Sobol Gaussian bands: the trajectory route (no band kernel draws
    # Sobol points), plain torch on the card
    ce.reset_launch_counts()
    res = smt.simulate_bands(sobol_gauss, SOBOL_BAND_PATHS, MAIN_MONTHS,
                             quantile_levels=qs, sample_paths=32,
                             n_bins=BAND_BINS)
    torch.cuda.synchronize()
    check(sum(ce.LAUNCHES.values()) == 0,
          f"Sobol bands: kernel launches {ce.LAUNCHES}")
    check(bool((res.month_hist.sum(axis=1) == SOBOL_BAND_PATHS).all()),
          f"Sobol bands: month masses {res.month_hist.sum(axis=1)}")
    exact = exact_marginals(gauss)
    devs = [rel(res.values[1, t], exact[1, t]) for t in BAND_MONTHS]
    check(max(devs) <= BAND_MEDIAN_REL,
          f"Sobol bands: median vs exact marginal rel {devs}")
    say("5b", f"Sobol Gaussian bands (hist) {SOBOL_BAND_PATHS} x "
              f"{MAIN_MONTHS}: every month's histogram holds "
              f"{SOBOL_BAND_PATHS} paths; median at months {BAND_MONTHS}: "
              f"{[float(res.values[1, t]) for t in BAND_MONTHS]} vs exact "
              f"{[float(exact[1, t]) for t in BAND_MONTHS]} (rel {devs})")
    res = smt.simulate_bands(gauss, MAIN_PATHS, MAIN_MONTHS, quantile_levels=qs,
                             sample_paths=32, band_mode="analytic")
    check(np.array_equal(res.values, exact_marginals(gauss))
          and res.sample_paths.shape == (32, MAIN_MONTHS + 1),
          "analytic bands")
    say("5b", "analytic bands: the exact marginals, 32 sample paths drawn "
              "on the card")

    # 5c. trajectories on the card against the same call on the CPU
    for model in (gauss, hist_model, sobol_gauss, sobol_hist, reference):
        for sname in ("none", "fixed_percent"):
            args = (model, TRAJ_PATHS, MAIN_MONTHS, 1000.0, 11,
                    strategies[sname])
            got = smt.simulate_paths(*args)
            want = smt.simulate_paths(*args, options=smt.EngineOptions(
                device="cpu"))
            r = float(np.max(np.abs(got / want - 1.0)))
            check(got.shape == (TRAJ_PATHS, MAIN_MONTHS + 1)
                  and np.isfinite(got).all() and r <= TRAJ_REL,
                  f"simulate_paths {model.kind} {sname}: rel {r}")
            say("5c", f"simulate_paths {model.kind} "
                      f"rng={getattr(model, 'rng', '-')} {sname} "
                      f"{TRAJ_PATHS} x {MAIN_MONTHS}: card vs CPU max rel "
                      f"{r} (bar {TRAJ_REL})")
    res = smt.run(hist_model, 1 << 20, MAIN_MONTHS, keep_trajectories=16,
                  options=smt.EngineOptions(trajectory_dtype="bfloat16"))
    want = smt.simulate_paths(hist_model, 16, MAIN_MONTHS, dtype="bfloat16")
    check(np.array_equal(res.trajectories, want),
          "run(keep_trajectories) differs from simulate_paths")
    say("5c", "run(keep_trajectories=16, bfloat16) == simulate_paths")

    # 6. timings: walls of the main paths, then per 2^24-path chunk at 360
    # months the kernel alone (the launcher's bare C call, uncounted), the
    # counted wrapper (kernel plus its torch epilogue) and the plain version
    walls = {}
    for key, (label, _, _, _) in main_paths.items():
        wall, reps = walls[key] = wall_median(lambda: main_run(key))
        say(6, f"[{card}] wall 100M x 360 {label}: median {wall!r} s of "
               f"{reps}")
    wall, reps = wall_median(big_hist_run)
    say(6, f"[{card}] wall 100M x 360 historical month loop, {BIG_BINS} "
           f"bins: median {wall!r} s of {reps} (4094 bins: "
           f"{walls['month_loop'][0]!r} s)")
    wall, reps = wall_median(lambda: smt.rqmc_estimate(
        sobol_gauss, RQMC_PATHS, MAIN_MONTHS, replicates=RQMC_REPLICATES,
        confidence=0.99))
    say(6, f"[{card}] wall rqmc_estimate Sobol Gaussian {RQMC_REPLICATES} x "
           f"{RQMC_PATHS} x {MAIN_MONTHS}: median {wall!r} s of {reps}")
    for key, (label, _, _) in band_paths.items():
        wall, reps = wall_median(lambda: band_run(key))
        say(6, f"[{card}] wall 100M x 360 {label}: median {wall!r} s of "
               f"{reps}")
    # the band histogram's cell edges, bisected once a simulate_bands call
    (_, _, ca, cb), _ = band_chunk_args(hist_model, smt.NoWithdrawal(),
                                        "hist", MAIN_MONTHS, CHUNK, CHUNK,
                                        seed=0)
    wall, reps = wall_median(lambda: bk.hist_edges(ca, cb, BAND_BINS))
    say(6, f"[{card}] hist_edges {MAIN_MONTHS} x {BAND_BINS + 1}: median "
           f"{wall!r} s of {reps} (once a bands call)")
    none = smt.NoWithdrawal()
    chunk_cases = {
        "month_loop": (month_chunk_args(hist_model, none, MAIN_MONTHS,
                                        CHUNK, CHUNK, 2000.0, seed=0),
                       ce.month_loop_launcher, ce.month_loop_chunk,
                       ce.month_loop_chunk_plain, 5, 1),
        "month_loop_gaussian": (month_chunk_args(gauss, none, MAIN_MONTHS,
                                                 CHUNK, CHUNK, 2000.0,
                                                 seed=0),
                                ce.month_loop_launcher, ce.month_loop_chunk,
                                ce.month_loop_chunk_plain, 5, 1),
        "law": (law_chunk_args(hist_model, MAIN_MONTHS, CHUNK, CHUNK, 2000.0,
                               seed=0, keep_finals=False),
                ce.law_launcher, ce.law_chunk, ce.law_chunk_plain, 20, 3),
        "law_with_finals": (law_chunk_args(hist_model, MAIN_MONTHS, CHUNK,
                                           CHUNK, 2000.0, seed=0,
                                           keep_finals=True),
                            ce.law_launcher, ce.law_chunk,
                            ce.law_chunk_plain, 20, 3),
    }
    for variant, sname in clt_cases.items():
        key = "clt" if variant == "plain" else f"clt_{variant}"
        chunk_cases[key] = (clt_chunk_args(variant, strategies[sname],
                                           MAIN_MONTHS, CHUNK, CHUNK, 2000.0,
                                           seed=0),
                            clt.clt_launcher, clt.clt_chunk,
                            clt.clt_chunk_plain, 5, 1)
    timed_models = {name: month_models[name] for name in (
        "month_loop_sobol_gaussian", "month_loop_sobol_historical",
        "month_loop_reference")}
    timed_models.update({f"{name}_deep": model
                         for name, model in deep_models.items()})
    for key, model in timed_models.items():
        chunk_cases[key] = (month_chunk_args(model, none, MAIN_MONTHS, CHUNK,
                                             CHUNK, 2000.0, seed=0),
                            ce.month_loop_launcher, ce.month_loop_chunk,
                            ce.month_loop_chunk_plain, 5, 1)
    band_kinds = {"bands_hist": (hist_model, "hist"),
                  "bands_hist_gaussian": (gauss, "hist"),
                  "bands_cdf": (gauss, "cdf"),
                  "bands_cdf_historical": (hist_model, "cdf")}
    band_launchers = {"hist": bk.month_hist_launcher,
                      "cdf": bk.month_cdf_launcher}
    for key, (model, reduce_kind) in band_kinds.items():
        _, wrapper, plain = band_fns["bands_" + reduce_kind]
        launcher = band_launchers[reduce_kind]
        chunk_cases[key] = (band_chunk_args(model, none, reduce_kind,
                                            MAIN_MONTHS, CHUNK, CHUNK,
                                            seed=0),
                            launcher, wrapper, plain, 5, 1)
    grid_kw = dict(seed=GRID_SEED, n_tiles=n_tiles, device=DEVICE)
    grid_fns = (cal.grid_overhead_launcher, cal.grid_overhead_chunk,
                cal.grid_overhead_chunk_plain)
    chunk_cases["grid_overhead"] = ((("const", 16), grid_kw), *grid_fns,
                                    20, 20)
    chunk_cases["grid_overhead_counter"] = ((("counter", 16), grid_kw),
                                            *grid_fns, 20, 5)
    calib_kw = dict(n_periods=MAIN_MONTHS, n_paths=CHUNK, seed=CALIB_SEED,
                    device=DEVICE)
    calib_fns = (cal.calib_launcher, cal.calib_chunk, cal.calib_chunk_plain)
    chunk_cases["calib"] = (((48,), calib_kw), *calib_fns, 5, 1)
    chunk_cases["calib_16"] = (((16,), calib_kw), *calib_fns, 5, 1)
    chunk_cases["counts_below_tile"] = (
        ((torch.as_tensor(tile, device=DEVICE),
          torch.as_tensor(np.exp(rng.normal(size=(32, 128))
                                 .astype(np.float32)), device=DEVICE)), {}),
        bk.counts_below_tile_launcher, bk.counts_below_tile,
        bk.counts_below_tile_plain, 20, 20)
    # the histogram kernel on the probes' inputs (2^24 indices and floats
    # over 4096 cells) and, in mode "spec", on the finals of the historical
    # month loop's first main chunk over BIG_BINS bins; the flatten of 2048
    # tiles; the Sobol draws at 1866 months with 64-bit positions
    from stock_market_monte_carlo_torch.bench import probes

    idx_t, x_t, _ = probes.inputs(CHUNK, DEVICE)
    ops, kw = month_chunk_args(hist_model, none, MAIN_MONTHS, CHUNK, CHUNK,
                               2000.0, seed=0)
    main_finals = ce.month_loop_chunk(*ops, **kw)[2]
    big = eng_spec(hist_model, MAIN_MONTHS, BIG_BINS)
    hist_fns = (histogram.histogram_launcher, histogram.histogram_counts,
                histogram.histogram_plain)
    chunk_cases["histogram_index"] = (((idx_t,), dict(
        hb=probes.CELLS, mode="index")), *hist_fns, 20, 3)
    chunk_cases["histogram_clip_cast"] = (((x_t,), dict(
        hb=probes.CELLS, mode="clip_cast")), *hist_fns, 20, 3)
    chunk_cases["histogram"] = (((main_finals,), dict(
        hb=BIG_BINS + 2, mode="spec", lo=big.lo, log_lo=big.log_lo,
        inv_w=1.0 / big.width)), *hist_fns, 20, 3)
    chunk_cases["flatten_tile"] = (((tiles,), {}),
                                   histogram.flatten_tile_launcher,
                                   histogram.flatten_tile,
                                   histogram.flatten_tile_plain, 20, 20)
    for name, model in long_models.items():
        chunk_cases[f"{name}_{SOBOL_MONTHS}"] = (
            month_chunk_args(model, none, SOBOL_MONTHS, CHUNK, CHUNK, 2000.0,
                             seed=0),
            ce.month_loop_launcher, ce.month_loop_chunk,
            ce.month_loop_chunk_plain, 3, 1)
    # the probes: the toys over a 2^24-path chunk equivalent, the CLT's
    # probe instances at 2^24 x 360, the byte planes of both experiments
    for op in cal.TOY_OPS:
        chunk_cases[f"op_toy_{op}"] = (
            ((op,), dict(n_tiles=cal.TOY_TILES, device=DEVICE)),
            cal.op_toy_launcher, cal.op_toy_chunk, cal.op_toy_chunk_plain, 5,
            3)
    probe_fns = (clt.clt_probe_launcher, clt.clt_probe_chunk,
                 clt.clt_probe_chunk_plain, 5, 1)
    for ablate in clt.ABLATIONS:
        ops, kw = probes.clt_probe_case(CHUNK, DEVICE, probes.ABLATE_SEED)
        chunk_cases[f"clt_probe_{ablate}"] = ((ops, dict(kw, ablate=ablate)),
                                              *probe_fns)
    for ts in clt.GROUPINGS[1:]:
        ops, kw = probes.clt_probe_case(CHUNK, DEVICE, probes.GROUPING_SEED)
        chunk_cases[f"clt_probe_ts{ts}"] = (
            (ops, dict(kw, ablate="base", tiles_per_block=ts)), *probe_fns)
    planes_fns = (bp.byte_planes_launcher, bp.byte_planes,
                  bp.byte_planes_plain, 20, 20)
    chunk_cases["byte_planes"] = (((bp.BYTES_SEEDS,), dict(device=DEVICE)),
                                  *planes_fns)
    chunk_cases["byte_planes_crossword"] = (
        ((bp.CROSSWORD_SEEDS,), dict(device=DEVICE)), *planes_fns)
    timings, timed_args = {}, {}
    for key, ((ops, kw), launcher, wrapper, plain, reps,
              plain_reps) in chunk_cases.items():
        if "keep_finals" in kw and not key.startswith("law_"):
            kw = dict(kw, keep_finals=False)
        timed_args[key] = ops, kw
        launch, _ = launcher(*ops, **kw)
        ms = events_ms(lambda _: launch(), reps, 1)
        wrapper_ms = events_ms(lambda _: wrapper(*ops, **kw), reps, 1)
        plain_ms = events_ms(lambda _: plain(*ops, **kw), plain_reps, 1)
        bound_ms, bound_by, work = roofline.bound(key, ops, kw)
        timings[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None)
        shape = ("per call, K=32" if key == "counts_below_tile" else
                 f"per {CHUNK} inputs" if key.startswith(("histogram",
                                                          "flatten"))
                 else f"per {cal.TOY_TILES} tiles x 12 passes"
                 if key.startswith("op_toy")
                 else f"per call, {len(ops[0])} seeds"
                 if key.startswith("byte_planes")
                 else f"per 2^24-path chunk x {kw['n_periods']} months"
                 if "n_periods" in kw else "per 2^24-path chunk")
        say(6, f"[{card}] {key}: kernel {ms!r} ms, wrapper {wrapper_ms!r} "
               f"ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
               f"({bound_by}: {work}) {shape}")
    # one PyTorch call per output computes the const grid overhead
    finals, partials = cal.grid_overhead_chunk_plain("const", 16, **grid_kw)
    timings["grid_overhead"]["library_ms"] = events_ms(
        lambda _: (finals.fill_(1.0), partials.fill_(2.0)), 20, 1)
    say(6, f"[{card}] grid_overhead: library (two fill_) "
           f"{timings['grid_overhead']['library_ms']!r} ms")
    # torch.bincount computes the index mode's counts in one call, copy_
    # the flatten; the clip-cast and spec modes take several calls
    timings["histogram_index"]["library_ms"] = events_ms(
        lambda _: histogram.library_counts(idx_t, probes.CELLS), 20, 1)
    say(6, f"[{card}] library: torch.bincount "
           f"{timings['histogram_index']['library_ms']!r} ms per {CHUNK} "
           "inputs")
    # the flatten and Tensor.copy_ in turns on the same buffers (kernel,
    # copy_, copy_, kernel); each time is the mean of its two turns
    flat_launch, flat_out = histogram.flatten_tile_launcher(tiles)
    flat_fns = (flat_launch, lambda: flat_out().copy_(tiles.view(-1, 1)))
    turns = [events_ms(lambda _: flat_fns[i](), 20, 3) for i in (0, 1, 1, 0)]
    flat = timings["flatten_tile"]
    flat["ms"] = (turns[0] + turns[3]) / 2
    flat["library_ms"] = (turns[1] + turns[2]) / 2
    say(6, f"[{card}] flatten_tile {CHUNK // ce.TILE_PATHS} tiles in turns: "
           f"kernel {turns[0]!r}, copy_ {turns[1]!r}, copy_ {turns[2]!r}, "
           f"kernel {turns[3]!r} ms; kernel/copy_ "
           f"{flat['ms'] / flat['library_ms']!r}")
    # 6c. the production CLT again, after the probe instances ran: within
    # CLT_TIME_REL of its phase-6 time
    launch, _ = clt.clt_launcher(*timed_args["clt"][0], **timed_args["clt"][1])
    again = events_ms(lambda _: launch(), 5, 3)
    drift = again / timings["clt"]["ms"] - 1.0
    check(abs(drift) <= CLT_TIME_REL,
          f"production CLT {again} ms vs {timings['clt']['ms']} ms earlier")
    say("6c", f"[{card}] production CLT again: {again!r} ms a chunk vs "
              f"{timings['clt']['ms']!r} ms in phase 6 ({drift:+.4f})")
    from stock_market_monte_carlo_torch.bench import headline

    report = headline.grid_overhead_report()
    check(report["counter_bits_identical_across_grouping"],
          f"grid overhead report: {report}")
    say(6, f"[{card}] grid overhead report: {json.dumps(report)}")

    # 6b. the histogram probes' reports on the card, each counted on its
    # own: the index and clip-cast histograms of 2^24 inputs, exact against
    # np.bincount, with their times and torch.bincount's; the flatten of
    # 2048 tiles of arange
    for label, report_fn, on_path in (
            ("hist_report", probes.hist_report,
             ("histogram_index", "histogram_clip_cast")),
            ("flatten_report", probes.flatten_report, ("flatten_tile",))):
        ce.reset_launch_counts()
        report = report_fn()
        torch.cuda.synchronize()
        counts = dict(ce.LAUNCHES)
        check(all(counts[k] > 0 for k in on_path)
              and all(v == 0 for k, v in counts.items() if k not in on_path),
              f"{label}: launches {counts}")
        for k in on_path:
            launches[k] = counts[k]
        check(all(v for k, v in report.items()
                  if k.endswith(("_exact_vs_bincount", "order_kept"))),
              f"{label}: {report}")
        say("6b", f"[{card}] {label}: launches "
                  f"{ {k: counts[k] for k in on_path} }; {json.dumps(report)}")

    # 6d. the probes' five reports on the card, each counted on its own:
    # the toys at 4096 tiles (with the calibration pair's int32 rate), the
    # ablation and the groupings at 2^24 x 360, the byte planes of both
    # experiments' seeds; each entry's launches are its report's
    toy_keys = tuple(f"op_toy_{op}" for op in cal.TOY_OPS)
    ablate_keys = tuple(f"clt_probe_{a}" for a in clt.ABLATIONS)
    ts_keys = tuple(f"clt_probe_ts{t}" for t in clt.GROUPINGS[1:])
    for label, report_fn, on_path, entries in (
            ("clt_toys_report", probes.clt_toys_report, toy_keys + ("calib",),
             {k: k for k in toy_keys}),
            ("clt_ablation_report", probes.clt_ablation_report, ablate_keys,
             {k: k for k in ablate_keys}),
            ("clt_grouping_report", probes.clt_grouping_report,
             ("clt_probe_base",) + ts_keys, {k: k for k in ts_keys}),
            ("byte_planes_report", probes.byte_planes_report,
             ("byte_planes",), {"byte_planes": "byte_planes"}),
            ("crossword_report", probes.crossword_report, ("byte_planes",),
             {"byte_planes_crossword": "byte_planes"})):
        ce.reset_launch_counts()
        report = report_fn()
        torch.cuda.synchronize()
        counts = dict(ce.LAUNCHES)
        check(all(counts[k] > 0 for k in on_path)
              and all(v == 0 for k, v in counts.items() if k not in on_path),
              f"{label}: launches {counts}")
        for entry, counter in entries.items():
            launches[entry] = counts[counter]
        say("6d", f"[{card}] {label}: launches "
                  f"{ {k: counts[k] for k in on_path} }; {json.dumps(report)}")
        if label == "clt_toys_report":
            check(all(math.isfinite(v) and v > 0 for v in (
                report["chain_floor_ms"], report["clt_ms_per_chunk"],
                report["hash_ms_per_chunk"])), f"{label}: {report}")
        elif label == "clt_ablation_report":
            check(report["variants"]["nohist"]["hist_mass"] == 0
                  and report["variants"]["base"]["hist_mass"] == CHUNK,
                  f"{label}: {report}")
        elif label == "clt_grouping_report":
            check(all(report["identical_to_ts0"].values())
                  and report["power_sums_max_rel_diff"] <= 1e-12,
                  f"{label}: {report}")
        elif label == "byte_planes_report":
            check(all(abs(m - 127.5) <= BYTE_MEAN_TOL
                      for m in report["byte_means"]), f"{label}: {report}")

    # 7. the headline benchmark at 100M x 360, in process, counted on its
    # own: it runs the law, historical and Gaussian month loops and the
    # CLT, then the dispatch floor and the calibration pair
    ce.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        full, compact = headline.main([str(MAIN_PATHS), str(MAIN_MONTHS)])
    torch.cuda.synchronize()
    counts = dict(ce.LAUNCHES)
    last = out.getvalue().strip().splitlines()[-1]
    check(len(last) < headline.LAST_LINE_MAX and json.loads(last) == compact,
          f"headline: last line {last!r}")
    on_path = ("law", "month_loop", "month_loop_gaussian", "clt",
               "grid_overhead", "calib")
    check(all(counts[k] > 0 for k in on_path)
          and all(v == 0 for k, v in counts.items() if k not in on_path),
          f"headline: launches {counts}")
    for key in ("grid_overhead", "calib", "counts_below_tile"):
        launches[key] = counts[key]
    extra = full["extra"]
    errs = {k: extra[f"mean_rel_err_vs_analytic_{k}"]
            for k in ("icdf", "clt", "terminal_law")}
    check(extra["means_ok"] and max(errs.values()) < HEADLINE_MEAN_REL,
          f"headline: mean errors {errs}, rows {extra['rows']}")
    rate = extra["device_time"]["int_op_rate_per_s"]
    check(math.isfinite(rate) and 0.0 < rate
          < 1.05 * roofline.SCALAR_OPS_PER_S,
          f"headline: int32 rate {rate}")
    say(7, f"[{card}] headline record: {json.dumps(full)}")
    say(7, f"headline 100M x 360: launches {counts}; mean errors {errs}; "
           f"int32 rate {rate!r}/s, {rate / roofline.SCALAR_OPS_PER_S!r} of "
           f"the assumed {roofline.SCALAR_OPS_PER_S!r}/s; last line "
           f"({len(last)} characters): {last}")
    # each timed kernel's share of its bound, at the assumed scalar rate and
    # at the int32 rate the headline measured
    shares = {key: [timings[key]["bound_ms"] / timings[key]["ms"],
                    roofline.bound(key, *args, scalar_rate=rate)[0]
                    / timings[key]["ms"]]
              for key, args in timed_args.items()}
    say(7, f"[{card}] share of the bound [at {roofline.SCALAR_OPS_PER_S!r}"
           f"/s, at the measured {rate!r}/s]: {json.dumps(shares)}")

    # 8. the bare launchers hold their outputs (ROADMAP queue 3, F4): a
    # launch after its outputs closure was dropped and an allocation of
    # each output's size writes its own outputs, as a kept closure's did
    from stock_market_monte_carlo_torch.bench import held_outputs

    for case in held_outputs.CASES:
        ok, detail = held_outputs.check(case)
        check(ok, f"held outputs of {case}: {detail}")
        say(8, f"{case}: launch holds its outputs: {json.dumps(detail)}")

    # 9. the samplers against their exact laws at 1e9 x 360, each counted
    # on its own (its warm-up chunk included): quantiles within 4 standard
    # errors and half a cell (the CLT's beside its predicted block
    # deviation), the count below the law's 1e-4 quantile within 4
    # binomial standard errors (not the CLT's)
    from stock_market_monte_carlo_torch.bench import validation

    for name, key in (("historical", "month_loop"),
                      ("icdf", "month_loop_gaussian"), ("clt", "clt")):
        ce.reset_launch_counts()
        rec = validation.validate(name, "cuda", LONG_PATHS, MAIN_MONTHS)
        torch.cuda.synchronize()
        counts = dict(ce.LAUNCHES)
        check(counts[key] > 0 and all(v == 0 for k, v in counts.items()
                                      if k != key),
              f"validation {name}: launches {counts}")
        check(rec["ok"], f"validation {name}: {json.dumps(rec)}")
        say(9, f"[{card}] validation {name}: launches {counts[key]}; "
               f"{json.dumps(rec)}")

    # 10. the scale and fault drill: the SIGKILLed checkpointed 1e9 x 360
    # month loop resumed bit for bit against a control; the law at 1e10 x
    # 360 (5 seed segments) and the month loop at 1e9 x 360; the cost of a
    # checkpoint, 3 pairs in turns. Each part counted on its own.
    from stock_market_monte_carlo_torch.bench import fault_drill

    sizes = fault_drill.FULL
    for part, fn, on_path in (
            ("fault", lambda: fault_drill.fault("cuda", sizes, False),
             ("month_loop",)),
            ("scale", lambda: fault_drill.scale("cuda", sizes),
             ("law", "month_loop")),
            ("checkpoint_cost",
             lambda: fault_drill.checkpoint_cost("cuda", sizes),
             ("law", "month_loop"))):
        ce.reset_launch_counts()
        rec = fn()
        torch.cuda.synchronize()
        counts = dict(ce.LAUNCHES)
        check(all(counts[k] > 0 for k in on_path)
              and all(v == 0 for k, v in counts.items() if k not in on_path),
              f"fault drill {part}: launches {counts}")
        check(rec.get("ok", True), f"fault drill {part}: {json.dumps(rec)}")
        say(10, f"[{card}] fault drill {part}: launches "
                f"{ {k: counts[k] for k in on_path} }; {json.dumps(rec)}")

    # 11. the paths mesh at 100M x 360
    mesh_phase(card, main_results, band_results)

    # 12. the user surfaces on the card: the CLI's commands, the native
    # library and the sweep
    surfaces_phase(card)

    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[COUNTER_OF.get(name, name)],
             max_abs_err=max_err[COUNTER_OF.get(name, name)],
             **timings[COUNTER_OF.get(name, name)])
        for name in KERNELS
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
