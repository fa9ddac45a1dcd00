"""GPU smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version on the card, drives the main path at
100M paths x 360 months, and times it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them, or when any
phase fails. Each phase prints one line. The line before the last holds
the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

GOLDEN_N = 8192 + 777
# the arithmetic stream's historical golden (tests/test_arith_golden.py)
GOLDEN = dict(t=7, head=[1084.7064, 1232.139, 1078.0762, 1086.5796],
              probes={1000: 1001.9213, 8192: 1077.0131, -1: 853.8689},
              total=9334839.723266602)
MAIN_PATHS = 100_000_000
MAIN_MONTHS = 360
CHUNK = 1 << 24
DEVICE = torch.device("cuda")
KERNELS = {
    "month_loop": dict(
        source="stock_market_monte_carlo_torch/csrc/month_loop.cu",
        replaces="stock_market_monte_carlo_tpu/ops/pallas_engine.py:1097"),
    "law": dict(
        source="stock_market_monte_carlo_torch/csrc/terminal_law.cu",
        replaces="stock_market_monte_carlo_tpu/ops/pallas_engine.py:1445"),
}


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
# Phase 3 helpers: one chunk through a kernel and its plain version.
# ---------------------------------------------------------------------------


def month_chunk_args(model, strategy, n_periods, valid, n_paths,
                     target, seed, tile0=0):
    from stock_market_monte_carlo_torch.engine import engine as eng
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    table, n_table = ce._pad_table(model.returns_pct)
    keep = (eng._keep_factors_np(strategy, n_periods)
            if eng._is_multiplicative(strategy)
            else np.ones((n_periods,), np.float32))
    spec = eng.make_histogram_spec(model, strategy, n_periods, 1000.0, 4094)
    kw = dict(n_table=n_table, strategy=strategy.kind,
              amount=float(getattr(strategy, "amount", 0.0)),
              n_periods=n_periods,
              seed_base=int(ce.seed_base_i32(seed).view(np.uint32)),
              tile0=tile0, valid=valid, n_paths=n_paths, v0=1000.0,
              target=target,
              shift=eng.analytic_moment_shift(model, strategy, n_periods),
              log_lo=spec.log_lo, inv_w=1.0 / spec.width,
              hb=spec.n_bins + 2, with_hist=True, keep_finals=True)
    return (torch.as_tensor(table, device=DEVICE),
            torch.as_tensor(keep, device=DEVICE)), kw


def law_chunk_args(model, n_periods, valid, n_paths, target, seed,
                   keep_finals, tile0=0):
    from stock_market_monte_carlo_torch.engine import engine as eng
    from stock_market_monte_carlo_torch.models.strategies import NoWithdrawal
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce
    from stock_market_monte_carlo_torch.ops import terminal_law as tlaw

    none = NoWithdrawal()
    fit = tlaw.fit_terminal_law(model, none, n_periods, 1000.0)
    spec = eng.make_histogram_spec(model, none, n_periods, 1000.0, 4094)
    kw = dict(seed_base=int(ce.seed_base_i32(seed).view(np.uint32))
              ^ ce.LAW_STREAM_XOR,
              tile0=tile0, valid=valid, n_paths=n_paths, v0=1000.0,
              target=target,
              shift=eng.analytic_moment_shift(model, none, n_periods),
              inv_zmax=1.0 / tlaw.LAW_ZMAX, log_lo=spec.log_lo,
              inv_w=1.0 / spec.width, hb=spec.n_bins + 2, with_hist=True,
              keep_finals=keep_finals)
    return (torch.as_tensor(fit.operand(), device=DEVICE),), kw


def moments_of(stats, shift):
    from stock_market_monte_carlo_torch.engine.engine import _absorb
    from stock_market_monte_carlo_torch.ops import reductions as red

    tot, _, _ = _absorb(((stats, np.zeros(1)), 0, 0),
                        red.zero_packed_stats(), np.zeros(1), [], False,
                        np.ones(9), shift)
    return red.MomentSummary.from_packed(tot, True)


def compare_chunk(label, k_out, p_out, shift, finals_rel):
    """Kernel output against plain output: counts, min and max exact;
    histogram total exact and cells within 2; mean, std and withdrawn
    within 1e-6; finals (when the kernel wrote them) exact (finals_rel=0)
    or within finals_rel. Returns the largest absolute finals difference."""
    torch.cuda.synchronize()
    sk, hk, fk = k_out
    sp, hp, fp = p_out
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    check(sk[0] == sp[0] and sk[7] == sp[7],
          f"{label}: counts {sk[[0, 7]]} vs {sp[[0, 7]]}")
    check(sk[5] == sp[5] and sk[6] == sp[6],
          f"{label}: min/max {sk[5:7]} vs {sp[5:7]}")
    hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
    check(hk.sum() == hp.sum() == sk[0],
          f"{label}: histogram mass {hk.sum()} vs {hp.sum()}")
    check(np.abs(hk - hp).max() <= 2,
          f"{label}: histogram cells differ by {np.abs(hk - hp).max()}")
    mk, mp = moments_of(sk, shift), moments_of(sp, shift)
    for field in ("mean", "std", "total_withdrawn"):
        a, b = getattr(mk, field), getattr(mp, field)
        check(a == b or rel(a, b) <= 1e-6, f"{label}: {field} {a} vs {b}")
    if fk is None:
        return 0.0
    fk, fp = fk.double(), fp.double()
    err = float((fk - fp).abs().max())
    if finals_rel == 0.0:
        check(torch.equal(fk, fp), f"{label}: finals differ (max {err})")
    else:
        r = float(((fk - fp).abs() / fp.abs()).max())
        check(r <= finals_rel, f"{label}: finals rel diff {r}")
    return err


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
    from stock_market_monte_carlo_torch.ops import _build
    from stock_market_monte_carlo_torch.ops import cuda_engine as ce

    # 2. build
    t = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load_library()
    say(2, f"built {path.name} in {time.perf_counter() - t:.1f} s")

    # 3. kernels against their plain versions on the card
    hist_model = smt.HistoricalBootstrap.from_csv()
    schedule = np.random.default_rng(7).uniform(0.0, 1.0, 360).astype(
        np.float32)
    strategies = {
        "none": smt.NoWithdrawal(),
        "fixed_percent": smt.FixedPercentWithdrawal(0.4),
        "variable_percent": smt.VariablePercentWithdrawal(schedule),
        "fixed_amount": smt.FixedAmountWithdrawal(5.0),
    }
    max_err = {"month_loop": 0.0, "law": 0.0}
    for n_periods, valid, n_paths, target in (
            (7, 8192 + 777, 2 * 8192, 1000.0),
            (360, 1 << 20, 1 << 20, 5000.0)):
        for name, strategy in strategies.items():
            ops, kw = month_chunk_args(hist_model, strategy, n_periods,
                                       valid, n_paths, target, seed=5)
            label = f"month_loop {name} {valid}x{n_periods}"
            err = compare_chunk(label, ce.month_loop_chunk(*ops, **kw),
                                ce.month_loop_chunk_plain(*ops, **kw),
                                kw["shift"], 0.0)
            max_err["month_loop"] = max(max_err["month_loop"], err)
            say(3, f"{label}: kernel == plain (finals max abs diff {err})")
    for keep_finals in (True, False):
        ops, kw = law_chunk_args(hist_model, MAIN_MONTHS, 1 << 20, 1 << 20,
                                 5000.0, seed=9, keep_finals=True)
        k_out = ce.law_chunk(*ops, **dict(kw, keep_finals=keep_finals))
        p_out = ce.law_chunk_plain(*ops, **kw)
        label = f"law finals={keep_finals} {1 << 20}x{MAIN_MONTHS}"
        err = compare_chunk(label, k_out, p_out, kw["shift"], 1e-6)
        max_err["law"] = max(max_err["law"], err)
        say(3, f"{label}: kernel matches plain (finals rel 1e-6, counts "
               "exact)")
    # ... and at the main path's own chunks (phase 5/6 calls): the first,
    # and the ragged last one at its tile offset, seed 0, target 2000
    n_chunks = -(-MAIN_PATHS // CHUNK)
    last = (n_chunks - 1) * CHUNK
    for tile0, valid, finals in ((0, CHUNK, False),
                                 (last // 8192, MAIN_PATHS - last, True)):
        ops, kw = month_chunk_args(hist_model, smt.NoWithdrawal(),
                                   MAIN_MONTHS, valid, CHUNK, 2000.0, seed=0,
                                   tile0=tile0)
        kw["keep_finals"] = finals
        label = f"month_loop main chunk tile0={tile0} valid={valid}"
        err = compare_chunk(label, ce.month_loop_chunk(*ops, **kw),
                            ce.month_loop_chunk_plain(*ops, **kw),
                            kw["shift"], 0.0)
        max_err["month_loop"] = max(max_err["month_loop"], err)
        say(3, f"{label}: kernel == plain (finals max abs diff {err})")
        ops, kw = law_chunk_args(hist_model, MAIN_MONTHS, valid, CHUNK,
                                 2000.0, seed=0, keep_finals=finals,
                                 tile0=tile0)
        label = f"law main chunk tile0={tile0} valid={valid}"
        err = compare_chunk(label, ce.law_chunk(*ops, **kw),
                            ce.law_chunk_plain(*ops, **kw), kw["shift"],
                            1e-6)
        max_err["law"] = max(max_err["law"], err)
        say(3, f"{label}: kernel matches plain (finals max abs diff {err})")

    # 4. golden on the card
    f = smt.simulate_final_values(
        smt.HistoricalBootstrap.from_csv(), GOLDEN_N, GOLDEN["t"], seed=12,
        options=smt.EngineOptions(chunk_paths=8192))
    check(np.array_equal(f[:4], np.float32(GOLDEN["head"])),
          f"golden head {f[:4]}")
    for idx, val in GOLDEN["probes"].items():
        check(f[idx] == np.float32(val), f"golden probe {idx}: {f[idx]}")
    total = float(np.sum(f, dtype=np.float64))
    check(rel(total, GOLDEN["total"]) <= 1e-12, f"golden total {total}")
    say(4, f"historical golden bit-exact on the card (total {total!r})")

    # 5./6. the main path, counted
    g_bar = 1.0 + float(np.mean(hist_model.returns_pct.astype(np.float64))
                        ) / 100.0
    analytic = 1000.0 * g_bar ** MAIN_MONTHS

    def main_run(**opts):
        return smt.simulate_stats(hist_model, MAIN_PATHS, MAIN_MONTHS,
                                  target_amount=2000.0,
                                  options=smt.EngineOptions(**opts))

    def check_main(label, res):
        check(res.moments.n == MAIN_PATHS, f"{label}: n {res.moments.n}")
        mass = float(res.histogram_counts.sum())
        check(mass == MAIN_PATHS, f"{label}: histogram mass {mass}")
        dev = abs(res.mean / analytic - 1.0)
        check(np.isfinite(res.mean) and dev < 1e-3,
              f"{label}: mean {res.mean} vs analytic {analytic}")
        return dev

    ce.reset_launch_counts()
    res = main_run()
    torch.cuda.synchronize()
    check(ce.LAUNCHES == {"month_loop": n_chunks, "law": 0},
          f"month-loop launches {ce.LAUNCHES}")
    dev = check_main("month loop", res)
    say(5, f"month loop 100M x 360: {ce.LAUNCHES['month_loop']} launches, "
           f"mass {MAIN_PATHS}, mean {res.mean!r} (analytic {analytic!r}, "
           f"rel dev {dev:.2e}), std {res.std!r}, "
           f"count_below {res.count_below}")
    res = main_run(terminal_law=True)
    torch.cuda.synchronize()
    check(ce.LAUNCHES == {"month_loop": n_chunks, "law": n_chunks},
          f"law launches {ce.LAUNCHES}")
    launches = dict(ce.LAUNCHES)
    dev = check_main("terminal law", res)
    say(6, f"terminal law 100M x 360: {launches['law']} launches, mass "
           f"{MAIN_PATHS}, mean {res.mean!r} (rel dev {dev:.2e}), "
           f"std {res.std!r}, count_below {res.count_below}")

    # 7. timings
    wall_loop, reps_loop = wall_median(main_run)
    wall_law, reps_law = wall_median(lambda: main_run(terminal_law=True))
    say(7, f"[{card}] wall 100M x 360 month loop: median {wall_loop!r} s "
           f"of {reps_loop}")
    say(7, f"[{card}] wall 100M x 360 terminal law: median {wall_law!r} s "
           f"of {reps_law}")
    ops_m, kw_m = month_chunk_args(hist_model, smt.NoWithdrawal(),
                                   MAIN_MONTHS, CHUNK, CHUNK, 2000.0, seed=0)
    kw_m["keep_finals"] = False
    ops_l, kw_l = law_chunk_args(hist_model, MAIN_MONTHS, CHUNK, CHUNK,
                                 2000.0, seed=0, keep_finals=False)
    # the kernel alone (the launcher's bare C call), the counted wrapper
    # (kernel plus its torch epilogue) and the plain version, per chunk
    launch_m, _ = ce.month_loop_launcher(*ops_m, **kw_m)
    launch_l, _ = ce.law_launcher(*ops_l, **kw_l)
    launch_f, _ = ce.law_launcher(*ops_l, **dict(kw_l, keep_finals=True))
    timings = {
        "month_loop": (
            device_ms(launch_m, 5),
            device_ms(lambda: ce.month_loop_chunk(*ops_m, **kw_m), 5),
            device_ms(lambda: ce.month_loop_chunk_plain(*ops_m, **kw_m), 1)),
        "law": (
            device_ms(launch_l, 20),
            device_ms(lambda: ce.law_chunk(*ops_l, **kw_l), 20),
            device_ms(lambda: ce.law_chunk_plain(*ops_l, **kw_l), 3)),
    }
    # the finals instance of the law kernel (simulate_final_values),
    # timed for the record; the main path runs the finals-free one
    kw_f = dict(kw_l, keep_finals=True)
    timings_all = dict(timings, law_with_finals=(
        device_ms(launch_f, 20),
        device_ms(lambda: ce.law_chunk(*ops_l, **kw_f), 20),
        device_ms(lambda: ce.law_chunk_plain(*ops_l, **kw_f), 3)))
    for name, (ms, wrapper_ms, plain_ms) in timings_all.items():
        say(7, f"[{card}] {name}: kernel {ms!r} ms, wrapper {wrapper_ms!r} "
               f"ms, plain {plain_ms!r} ms per 2^24-path chunk x "
               f"{MAIN_MONTHS} months")

    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[name], max_abs_err=max_err[name],
             ms=timings[name][0], plain_ms=timings[name][2])
        for name in KERNELS
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
