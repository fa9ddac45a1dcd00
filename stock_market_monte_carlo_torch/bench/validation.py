"""The samplers against their exact laws at scale: 1e9 paths x 360 months.

The port's counterpart of the JAX package's two validation scripts
(``scripts/tail_validation_tpu.py``, ``scripts/bootstrap_law_validation_tpu.py``).
Three ``simulate_stats`` runs on the default market and the vendored
1127-month table, each held against an independent float64 oracle
(``ops/analytic.py``):

- ``historical``: the counter-stream bootstrap against
  ``bootstrap_final_value_distribution``;
- ``icdf``: ``GaussianReturns(0.5, 10/12)`` on the ICDF month loop against
  ``clt_final_value_distribution(law="normal")``;
- ``clt``: the same model on the CLT sampler against
  ``clt_final_value_distribution()`` shifted by the predicted block
  deviation ``clt_tail_deviation(p)``.

The histogram quantiles at ``PS`` and the count below the law's 1e-4
quantile (``target_amount``) are compared. The bars come from the
statistics, not from the runs: a quantile's relative error, less its
predicted deviation, lies within 4 se_q(p) + h, where se_q(p) =
sqrt(p (1-p) / n) / f(q_p) (f the oracle's density of log V_T at the
quantile) and h half a histogram cell's log-width; the CLT gets a further
0.25 |d(p)| (the JAX package's TPU run measured up to 22 % between
prediction and run). The count below must lie within 4 binomial standard
errors of the law for the historical and ICDF runs; the CLT's ratio is
printed and not held (its deep tail is pulled in).

    python -m stock_market_monte_carlo_torch.bench.validation \\
        [--device cuda|cpu] [--n N] [--months T] [--seed S]

One line per sampler (``[validation] <name>: <json>``); exits 1 when a bar
is missed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

PS = (1e-5, 1e-4, 1e-3, 0.01, 0.5, 0.99, 1 - 1e-3, 1 - 1e-4, 1 - 1e-5)
MARKET = (0.5, 10.0 / 12.0)
V0 = 1000.0
SEED = 20260817
SAMPLERS = ("historical", "icdf", "clt")
SE_BAR = 4.0          # standard errors of a quantile or a count
CLT_PRED_SLACK = 0.25  # of the predicted CLT deviation |d(p)|


def _model(name):
    import stock_market_monte_carlo_torch as smt

    if name == "historical":
        return smt.HistoricalBootstrap.from_csv()
    return smt.GaussianReturns(*MARKET)


def oracle(name, model, months):
    """(values, cdf) of the law ``name`` is held to, and the predicted
    relative deviation d(p) of its quantiles (0 but for the CLT)."""
    from stock_market_monte_carlo_torch.ops import analytic as an

    if name == "historical":
        law = an.bootstrap_final_value_distribution(
            np.asarray(model.returns_pct, np.float64), months, V0)
    else:
        law = an.clt_final_value_distribution(
            *MARKET, months, V0, law="clt" if name == "clt" else "normal")
    pred = [an.clt_tail_deviation(p, *MARKET, months) if name == "clt"
            else 0.0 for p in PS]
    return law, pred


def log_density(values, cdf, x, delta):
    """The oracle's density of log V_T at x: its CDF's central difference
    over +-delta in log V."""
    lv = np.log(values)
    lo, hi = np.interp([np.log(x) - delta, np.log(x) + delta], lv, cdf)
    return (hi - lo) / (2.0 * delta)


def validate(name, device="cuda", n=1_000_000_000, months=360, seed=SEED):
    """One sampler's run against its law: the record printed by ``main``,
    with ``ok`` False where a bar is missed."""
    import torch

    import stock_market_monte_carlo_torch as smt
    from stock_market_monte_carlo_torch.ops import analytic as an

    model = _model(name)
    t0 = time.perf_counter()
    (values, cdf), pred = oracle(name, model, months)
    oracle_s = time.perf_counter() - t0
    q_law = an.quantiles_from_cdf(values, cdf, PS)
    x_tail = float(q_law[1])        # the law's 1e-4 quantile
    opts = smt.EngineOptions(
        device=device, gaussian_sampler="clt" if name == "clt" else "icdf")
    # warm-up at one chunk: the timed wall leaves out the first call's costs
    smt.simulate_stats(model, min(n, opts.chunk_paths), months, V0, seed,
                       target_amount=x_tail, options=opts)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = smt.simulate_stats(model, n, months, V0, seed,
                             target_amount=x_tail, options=opts)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    q_mc = res.quantiles(PS)
    h = 0.5 * res.histogram_spec.width
    rows, ok = [], True
    for p, law_q, d in zip(PS, q_law, pred):
        f = log_density(values, cdf, law_q, h)
        se = np.sqrt(p * (1.0 - p) / n) / f
        bar = SE_BAR * se + h + (CLT_PRED_SLACK * abs(d) if name == "clt"
                                 else 0.0)
        dev = q_mc[p] / law_q - 1.0
        row_ok = bool(abs(dev - d) <= bar)
        ok &= row_ok
        rows.append(dict(p=p, mc=q_mc[p], law=float(law_q), rel=dev,
                         predicted=d, bar=float(bar), ok=row_ok))
    p_law = float(np.interp(x_tail, values, cdf))
    ratio = res.count_below / (n * p_law)
    ratio_se = float(np.sqrt((1.0 - p_law) / (p_law * n)))
    count_ok = name == "clt" or abs(ratio - 1.0) <= SE_BAR * ratio_se
    ok &= bool(count_ok)
    g = (1.0 + np.asarray(model.returns_pct, np.float64) / 100.0).mean() \
        if name == "historical" else 1.0 + MARKET[0] / 100.0
    return dict(
        sampler=name, device=device, n_paths=n, n_periods=months,
        seed=seed, wall_s=wall, paths_per_s=n / wall, oracle_s=oracle_s,
        quantiles=rows, target=x_tail, count_below=res.count_below,
        p_law=p_law, count_ratio=ratio, count_ratio_se=ratio_se,
        count_held=name != "clt", count_ok=bool(count_ok),
        mean_rel_err=res.mean / (V0 * g**months) - 1.0,
        hist_mass=float(np.asarray(res.histogram_counts).sum()), ok=ok)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1_000_000_000)
    ap.add_argument("--months", type=int, default=360)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--only", nargs="*", choices=SAMPLERS, default=SAMPLERS)
    args = ap.parse_args(argv)
    records = []
    for name in args.only:
        rec = validate(name, args.device, args.n, args.months, args.seed)
        print(f"[validation] {name}: {json.dumps(rec)}", flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main()) else 1)
