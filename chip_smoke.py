"""GPU smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version on the card, drives the main paths at
100M paths x 360 months (historical month loop, terminal law, Gaussian ICDF
month loop, CLT sampler, the Sobol Gaussian, Sobol historical and
reference-parity historical month loops, historical bands in hist mode,
Gaussian bands in cdf mode), checks replicated-RQMC intervals, Sobol bands
and trajectories on the card against the CPU, and times the kernels and
the paths.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them, or when any
phase fails. Each phase prints one line. The line before the last holds
the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
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
MAIN_MONTHS = 360
CHUNK = 1 << 24
# paths of the kernel-against-plain checks at the main paths' months
CHECK_PATHS = 1 << 20
DEVICE = torch.device("cuda")
_PE = "stock_market_monte_carlo_tpu/ops/pallas_engine.py"
_PB = "stock_market_monte_carlo_tpu/ops/pallas_bands.py"
_CSRC = "stock_market_monte_carlo_torch/csrc"
KERNELS = {
    "month_loop": dict(source=f"{_CSRC}/month_loop.cu",
                       replaces=f"{_PE}:1097"),
    "month_loop_gaussian": dict(source=f"{_CSRC}/month_loop.cu",
                                replaces=f"{_PE}:1097"),
    "month_loop_sobol_gaussian": dict(source=f"{_CSRC}/month_loop.cu",
                                      replaces=f"{_PE}:1097"),
    "month_loop_sobol_historical": dict(source=f"{_CSRC}/month_loop.cu",
                                        replaces=f"{_PE}:1097"),
    "month_loop_reference": dict(source=f"{_CSRC}/month_loop.cu",
                                 replaces=f"{_PE}:1097"),
    "law": dict(source=f"{_CSRC}/terminal_law.cu", replaces=f"{_PE}:1445"),
    "clt": dict(source=f"{_CSRC}/clt.cu", replaces=f"{_PE}:1048"),
    "bands_hist": dict(source=f"{_CSRC}/bands.cu", replaces=f"{_PB}:249"),
    "bands_cdf": dict(source=f"{_CSRC}/bands.cu", replaces=f"{_PB}:494"),
}
BAND_BINS = 1024
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

# Peak rates for the bounds: NVIDIA's H100 SXM data sheet (HBM, bf16 tensor
# cores) and the Hopper architecture white paper (132 SMs, 4 sub-partitions
# of 32 lanes, 1.98 GHz boost). The data sheet gives no int32 rate; the
# scalar rate below is the issue limit of any 32-bit instruction (one warp
# instruction per clock per sub-partition), which is also the data sheet's
# 67 TFLOP/s float32 with an FMA counted as one operation. The kernels are
# built with -fmad=false, so each float op is its own instruction.
HBM_BYTES_PER_S = 3.35e12
TENSOR_BF16_FLOP_PER_S = 989e12
SCALAR_OPS_PER_S = 132 * 128 * 1.98e9

# 32-bit scalar operations, counted from the kernels' sources; a libm call
# (logf, expf, log1pf, sqrtf) counts as one, so the bounds err low.
_HASH = 8                     # finalize: 3 shifts, 3 xors, 2 multiplies
_WORD = _HASH + 2             # arith_word: + multiply, add
_IDX = 7                      # idx_exact
# u23 (4), 2u-1 (2), -log1p(-x*x) (4), the p polynomial (17), select and
# two scales (3); the q polynomial (sqrtf, -3, 16) only where w >= 5, i.e.
# |2u-1| >= sqrt(1 - e^-5)
_NORMAL_Z = 30 + 18 * (1.0 - math.sqrt(1.0 - math.exp(-5.0)))
_EPILOGUE = 25                # Stats.add (16) and bin_index + atomic (9)
# a Sobol word as the function needs it: the Gray-code recurrence along
# consecutive positions (one direction load, one XOR), then the shift XOR;
# the kernel's per-bit fold is a cost of its design, not counted
_SOBOL = 3
_XORSHIFT = 6                 # three shifts, three xors


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# One chunk's operands, as engine._chunk_fn builds them.
# ---------------------------------------------------------------------------


def _common(model, strategy, n_periods, valid, n_paths, target, tile0):
    from stock_market_monte_carlo_torch.engine import engine as eng

    spec = eng.make_histogram_spec(model, strategy, n_periods, 1000.0, 4094)
    return dict(tile0=tile0, valid=valid, n_paths=n_paths, v0=1000.0,
                target=target,
                shift=eng.analytic_moment_shift(model, strategy, n_periods),
                log_lo=spec.log_lo, inv_w=1.0 / spec.width,
                hb=spec.n_bins + 2, with_hist=True, keep_finals=True)


def _keep(strategy, n_periods):
    from stock_market_monte_carlo_torch.engine import engine as eng

    return (eng._keep_factors_np(strategy, n_periods)
            if eng._is_multiplicative(strategy)
            else np.ones((n_periods,), np.float32))


def _base(seed):
    from stock_market_monte_carlo_torch.engine import engine as eng

    return eng._segment_base(seed, 0)


def month_chunk_args(model, strategy, n_periods, valid, n_paths, target,
                     seed, tile0=0):
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
                      tile0),
              strategy=strategy.kind,
              amount=float(getattr(strategy, "amount", 0.0)),
              n_periods=n_periods, seed_base=_base(seed), **draw)
    return (table, torch.as_tensor(_keep(strategy, n_periods),
                                   device=DEVICE)), kw


def law_chunk_args(model, n_periods, valid, n_paths, target, seed,
                   keep_finals, tile0=0):
    from stock_market_monte_carlo_torch.models.strategies import NoWithdrawal
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce
    from stock_market_monte_carlo_torch.ops import terminal_law as tlaw

    none = NoWithdrawal()
    fit = tlaw.fit_terminal_law(model, none, n_periods, 1000.0)
    kw = dict(_common(model, none, n_periods, valid, n_paths, target, tile0),
              seed_base=_base(seed) ^ ce.LAW_STREAM_XOR,
              inv_zmax=1.0 / tlaw.LAW_ZMAX, keep_finals=keep_finals)
    return (torch.as_tensor(fit.operand(), device=DEVICE),), kw


def band_chunk_args(model, strategy, kind, n_periods, valid, n_paths, seed,
                    tile0=0):
    """(table, keep, coef_a, coef_b), kwargs of one band chunk with the
    coefficients simulate_bands builds; ``kind`` "hist" or "cdf"."""
    from stock_market_monte_carlo_torch.engine import bands as bands_eng
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    centers, scales = bands_eng.band_grid(model, strategy, n_periods, 1000.0)
    if kind == "hist":
        ca, cb, _ = bands_eng.hist_coefficients(centers, scales, BAND_BINS,
                                                1000.0)
        reduce_kw = dict(n_bins=BAND_BINS)
    else:
        ca, cb, klo, khi, _, _ = bands_eng.cdf_coefficients(
            centers, scales, BAND_THRESHOLDS, 1000.0)
        reduce_kw = dict(kappa_lo=klo, kappa_hi=khi,
                         n_thresholds=BAND_THRESHOLDS)
    table, draw = ce.draw_operands(model, DEVICE)
    keep = (None if strategy.kind == "none"
            else torch.as_tensor(_keep(strategy, n_periods), device=DEVICE))
    kw = dict(n_periods=n_periods, seed_base=_base(seed), tile0=tile0,
              valid=valid, n_paths=n_paths, v0=1000.0, **draw, **reduce_kw)
    return (table, keep, torch.as_tensor(ca, device=DEVICE),
            torch.as_tensor(cb, device=DEVICE)), kw


def clt_chunk_args(variant, strategy, n_periods, valid, n_paths, target,
                   seed, tile0=0):
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
                      tile0),
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


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------


def device_ms(fn, reps):
    """Milliseconds per call on the card's clock: CUDA events around
    ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def _io_bytes(ops, kw, rows_per_block, blocks_per_sm):
    """Bytes each input is read once and each output written once: the
    operand tensors, the per-block partial rows, the histogram and (when
    kept) the finals."""
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    n_blocks = ce._launch_geometry(DEVICE, kw["valid"], kw["hb"],
                                   kw["with_hist"], rows_per_block,
                                   blocks_per_sm)
    inputs = sum(t.numel() * t.element_size() for t in ops if t is not None)
    return (inputs + n_blocks * 8 * 8 + kw["hb"] * 4
            + (kw["valid"] * 4 if kw["keep_finals"] else 0))


def bound(name, ops, kw):
    """(bound_ms, bound_by, work) for one chunk of kernel ``name`` on
    these operands: the larger of the bytes over the HBM rate and each
    kind of operation over its peak rate. Operations are counted from the
    kernel source for what the function needs; words a TPU row shares
    (the draw key of a tile-month, the source lane's word of the
    historical draw) are counted once."""
    from stock_market_monte_carlo_torch.ops import clt
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    valid = kw["valid"]
    tensor_flop = 0.0
    if name.startswith("bands"):
        t = kw["n_periods"]
        if kw["draw"] == "historical":
            n = kw["n_table"]
            tail_n = n - (ops[0].numel() - 128)
            per = _WORD + _IDX + 1 + 3 * (1.0 - tail_n / n) + 13
        else:
            per = _WORD + _NORMAL_Z + 2
        keep = 0 if ops[1] is None else 1
        if name.startswith("bands_hist"):
            # fmaxf, logf, multiply, add, floorf, two clamps, convert, +1,
            # the shared-memory atomic
            reduce_ops, cells = 10, kw["n_bins"] + 2
        else:
            # what the count needs, not the kernel's binary search: the
            # interior thresholds lie on an affine log grid, so the
            # histogram's cell arithmetic and atomic give the cell; then a
            # threshold load and a compare correct it, and two compares
            # place the guard rows
            k = kw["n_thresholds"]
            reduce_ops = 10 + 4
            cells = k + 1
        # per path-month: draw, keep, compounding, reduction; per
        # tile-month the draw key
        scalar = (valid * t * (per + keep + 1 + reduce_ops)
                  + (valid / ce.TILE_PATHS) * t * _WORD)
        nbytes = (sum(x.numel() * x.element_size() for x in ops
                      if x is not None) + t * cells * 4)
    elif name.startswith("month_loop"):
        t = kw["n_periods"]
        strat = {"none": 0, "fixed_percent": 3, "variable_percent": 3,
                 "fixed_amount": 4}[kw["strategy"]]
        draw = kw["draw"]
        # per path-month: the draw, its growth; per path: the stream's
        # setup (the reference state's pcg hash); per tile-month: the
        # counter stream's draw key
        setup, key_words = 0, 0
        if draw == "historical":
            table, n = ops[0].numel(), kw["n_table"]
            tail_n = n - (table - 128)
            # own word, dest index and test, the row rotation where the
            # draw leaves the tail, the source lane's index map and the
            # shared-memory gather
            per = _WORD + _IDX + 1 + 3 * (1.0 - tail_n / n) + 13
            key_words = _WORD
        elif draw == "gaussian":
            per = _WORD + _NORMAL_Z + 2
            key_words = _WORD
        elif draw == "sobol_gaussian":
            per = _SOBOL + _NORMAL_Z + 2
        elif draw == "sobol_historical":
            per = _SOBOL + _IDX + 1
        else:
            per = _XORSHIFT + _IDX + 1
            setup = 6
        per_path = t * (per + 1 + strat) + setup + _EPILOGUE
        scalar = valid * per_path + (valid / ce.TILE_PATHS) * t * key_words
        sobol_ops = [kw.get("direction"), kw.get("sobol_shift")]
        nbytes = _io_bytes(list(ops) + sobol_ops, kw, 256, 8)
    elif name.startswith("law"):
        d = ops[0].numel() - 1
        scalar = valid * (_WORD + _NORMAL_Z + 2 + 3 * (d - 1) + 5
                          + _EPILOGUE)
        nbytes = _io_bytes(ops, kw, 256, 8)
    elif name.startswith("clt"):
        nblocks = ops[1].shape[0]
        k = clt.CLT_K
        # per block: k words, each shifted, converted and rounded to bf16;
        # the affine step; then the product over blocks (plain) or the
        # prefix step per column (gk, exp, excl*g*(1-k), add, max, log,
        # add) and the carry (prefix)
        per_block = k * (_WORD + 3) + 2 * k
        if kw["variant"] == "prefix":
            per_block += 9 * k + 6
            finish = 1
        else:
            per_block += k
            finish = 2 * k + 2
        scalar = valid * (nblocks * per_block + finish + _EPILOGUE)
        tensor_flop = valid * nblocks * 2.0 * k * k
        nbytes = _io_bytes(ops, kw, 64, 2)
    else:
        raise ValueError(name)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(scalar / SCALAR_OPS_PER_S,
                tensor_flop / TENSOR_BF16_FLOP_PER_S)
    work = dict(bytes=nbytes, scalar_ops=scalar, tensor_flop=tensor_flop)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", work
    return t_ops * 1e3, "operations", work


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------


def main():
    # 1. device
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    say(1, f"device {kind} (count {count}); nvidia-smi: {card}; torch "
           f"{torch.__version__} CUDA {torch.version.cuda}")

    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.ops import _build, clt
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    # 2. build
    t = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load_library()
    say(2, f"built {path.name} in {time.perf_counter() - t:.1f} s")

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
    # the Sobol draws at 64-bit positions (index_offset 2^33 + 777)
    for name, model in deep_models.items():
        for sname in ("none", "fixed_percent"):
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
    # last one at its own tile offset (seed 0, target 2000)
    n_chunks = -(-MAIN_PATHS // CHUNK)
    last = (n_chunks - 1) * CHUNK
    for first, valid in ((0, CHUNK), (last, MAIN_PATHS - last)):
        finals = first != 0
        tile0 = first // ce.TILE_PATHS
        for name, model in month_models.items():
            ops, kw = month_chunk_args(model, smt.NoWithdrawal(),
                                       MAIN_MONTHS, valid, CHUNK, 2000.0,
                                       seed=0, tile0=tile0)
            run_pair(name, f"{name} main chunk tile0={tile0} valid={valid}",
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
    for key, (label, _, _, g_bar) in main_paths.items():
        ce.reset_launch_counts()
        res = main_run(key)
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
    qs = (0.05, 0.5, 0.95)

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

    for key, (label, model, kw) in band_paths.items():
        ce.reset_launch_counts()
        res = band_run(key)
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
    for key, (label, _, _, _) in main_paths.items():
        wall, reps = wall_median(lambda: main_run(key))
        say(6, f"[{card}] wall 100M x 360 {label}: median {wall!r} s of "
               f"{reps}")
    for key, (label, _, _) in band_paths.items():
        wall, reps = wall_median(lambda: band_run(key))
        say(6, f"[{card}] wall 100M x 360 {label}: median {wall!r} s of "
               f"{reps}")
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
    timings = {}
    for key, ((ops, kw), launcher, wrapper, plain, reps,
              plain_reps) in chunk_cases.items():
        if "keep_finals" in kw and not key.startswith("law_"):
            kw = dict(kw, keep_finals=False)
        launch, _ = launcher(*ops, **kw)
        ms = device_ms(launch, reps)
        wrapper_ms = device_ms(lambda: wrapper(*ops, **kw), reps)
        plain_ms = device_ms(lambda: plain(*ops, **kw), plain_reps)
        bound_ms, bound_by, work = bound(key, ops, kw)
        timings[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        say(6, f"[{card}] {key}: kernel {ms!r} ms, wrapper {wrapper_ms!r} "
               f"ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
               f"({bound_by}: {work}) per 2^24-path chunk x {MAIN_MONTHS} "
               "months")

    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[name], max_abs_err=max_err[name],
             **timings[name], library_ms=None)
        for name in KERNELS
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
