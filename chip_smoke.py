"""GPU smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version on the card, drives the main paths at
100M paths x 360 months (historical month loop, terminal law, Gaussian ICDF
month loop, CLT sampler), and times them.

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
DEVICE = torch.device("cuda")
_PE = "stock_market_monte_carlo_tpu/ops/pallas_engine.py"
_CSRC = "stock_market_monte_carlo_torch/csrc"
KERNELS = {
    "month_loop": dict(source=f"{_CSRC}/month_loop.cu",
                       replaces=f"{_PE}:1097"),
    "month_loop_gaussian": dict(source=f"{_CSRC}/month_loop.cu",
                                replaces=f"{_PE}:1097"),
    "law": dict(source=f"{_CSRC}/terminal_law.cu", replaces=f"{_PE}:1445"),
    "clt": dict(source=f"{_CSRC}/clt.cu", replaces=f"{_PE}:1048"),
}

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
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    return int(ce.seed_base_i32(seed).view(np.uint32))


def month_chunk_args(model, strategy, n_periods, valid, n_paths, target,
                     seed, tile0=0):
    """(table, keep), kwargs of one month-loop chunk; the draw follows the
    model (historical table or Gaussian a + b*z)."""
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    if model.kind == "historical":
        table_np, n_table = ce._pad_table(model.returns_pct)
        table = torch.as_tensor(table_np, device=DEVICE)
        draw = dict(draw="historical", n_table=n_table)
    else:
        a, b = ce.gaussian_ab(model.mean_pct, model.std_pct)
        table, draw = None, dict(draw="gaussian", a=a, b=b)
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
    if name.startswith("month_loop"):
        t = kw["n_periods"]
        strat = {"none": 0, "fixed_percent": 3, "variable_percent": 3,
                 "fixed_amount": 4}[kw["strategy"]]
        if kw["draw"] == "historical":
            table, n = ops[0].numel(), kw["n_table"]
            tail_n = n - (table - 128)
            # own word, dest index and test, the row rotation where the
            # draw leaves the tail, the source lane's index map and the
            # shared-memory gather
            per = _WORD + _IDX + 1 + 3 * (1.0 - tail_n / n) + 13
        else:
            per = _WORD + _NORMAL_Z + 2
        per_path = t * (per + 1 + strat) + _EPILOGUE
        scalar = valid * per_path + (valid / ce.TILE_PATHS) * t * _WORD
        nbytes = _io_bytes(ops, kw, 256, 8)
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
    schedule = np.random.default_rng(7).uniform(0.0, 1.0, 360).astype(
        np.float32)
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
            (360, 1 << 20, 1 << 20, 5000.0)):
        for model, name in ((hist_model, "month_loop"),
                            (gauss, "month_loop_gaussian")):
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
    for keep_finals in (True, False):
        ops, kw = law_chunk_args(hist_model, MAIN_MONTHS, 1 << 20, 1 << 20,
                                 5000.0, seed=9, keep_finals=keep_finals)
        run_pair("law", f"law finals={keep_finals} {1 << 20}x{MAIN_MONTHS}",
                 ce.law_chunk, ce.law_chunk_plain, ops, kw, 0.0,
                 plain_kw=dict(kw, keep_finals=True))
    # ... and at the main paths' own chunks: the first, and the ragged
    # last one at its own tile offset (seed 0, target 2000)
    n_chunks = -(-MAIN_PATHS // CHUNK)
    last = (n_chunks - 1) * CHUNK
    for first, valid in ((0, CHUNK), (last, MAIN_PATHS - last)):
        finals = first != 0
        tile0 = first // ce.TILE_PATHS
        for model, name in ((hist_model, "month_loop"),
                            (gauss, "month_loop_gaussian")):
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

    # 6. timings: walls of the main paths, then per 2^24-path chunk at 360
    # months the kernel alone (the launcher's bare C call, uncounted), the
    # counted wrapper (kernel plus its torch epilogue) and the plain version
    for key, (label, _, _, _) in main_paths.items():
        wall, reps = wall_median(lambda: main_run(key))
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
    timings = {}
    for key, ((ops, kw), launcher, wrapper, plain, reps,
              plain_reps) in chunk_cases.items():
        if not key.startswith("law_"):
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
