"""Benchmark comparison — the reference workflow's analysis surface (the
port's copy of ``stock_market_monte_carlo_tpu/bench/compare.py``; pure
Python, matplotlib imported only to plot).

The reference compares runs two ways (README.md:87-96,
python/benchmark_compare.py:103-143):

1. ``benchmark/tools/compare.py`` over Google-Benchmark JSON with
   ``--benchmark_repetitions=10`` — a Mann-Whitney U test decides whether
   the time distributions actually differ;
2. ``benchmark_compare.py`` plots metrics relative to a baseline.

Both capabilities live here: ``compare_files`` reads two benchmark JSON
files (our ``smmc-torch benchmark-google`` output or Google-Benchmark JSON —
per-repetition entries and/or aggregates), prints a side-by-side table
with speedups, runs the U test whenever both sides carry repetition
samples, and can plot absolute times plus a relative-to-baseline panel.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional


def mann_whitney_u(xs: List[float], ys: List[float]):
    """Two-sided Mann-Whitney U test (normal approximation, tie-corrected,
    continuity-corrected). Returns (U, p_value).

    The same decision rule Google Benchmark's compare.py applies to
    repetition samples: small p => the two time distributions differ.
    """
    n1, n2 = len(xs), len(ys)
    if n1 < 2 or n2 < 2:
        raise ValueError("need >= 2 samples per side")
    pooled = sorted((v, 0) for v in xs)
    pooled = sorted(pooled + [(v, 1) for v in ys])
    # average ranks for ties
    ranks = [0.0] * len(pooled)
    i = 0
    tie_term = 0.0
    while i < len(pooled):
        j = i
        while j < len(pooled) and pooled[j][0] == pooled[i][0]:
            j += 1
        avg_rank = (i + j + 1) / 2.0  # ranks are 1-based
        for k in range(i, j):
            ranks[k] = avg_rank
        t = j - i
        tie_term += t**3 - t
        i = j
    r1 = sum(r for r, (_, side) in zip(ranks, pooled) if side == 0)
    u1 = r1 - n1 * (n1 + 1) / 2.0
    u = min(u1, n1 * n2 - u1)
    n = n1 + n2
    mu = n1 * n2 / 2.0
    var = n1 * n2 / 12.0 * ((n + 1) - tie_term / (n * (n - 1)))
    if var <= 0:  # all values identical
        return u, 1.0
    z = (u - mu + 0.5) / math.sqrt(var)
    p = math.erfc(-z / math.sqrt(2.0))  # 2*Phi(z), z <= 0 here
    return u, min(p, 1.0)


def _load(path) -> Dict[str, dict]:
    """name -> {time, unit, samples, paths_per_second}.

    Accepts per-repetition entries (Google Benchmark ``run_type:
    iteration`` / ``repetition_index``), aggregate entries
    (``aggregate_name`` mean/median/stddev), and our single-entry format
    with ``real_time_median``. Samples group by the family name with any
    ``_mean``/``_median``/``_stddev`` suffix stripped.
    """
    with open(path) as f:
        data = json.load(f)
    out: Dict[str, dict] = {}
    for b in data.get("benchmarks", []):
        name = b.get("name", "?")
        family = name
        for suffix in ("_mean", "_median", "_stddev", "_cv"):
            if family.endswith(suffix):
                family = family[: -len(suffix)]
        if "time_unit" in b:
            unit = b["time_unit"]
        elif "run_type" in b or "aggregate_name" in b:
            # entry shaped like Google Benchmark output but missing
            # time_unit: GB's default unit is nanoseconds — defaulting to
            # seconds here would mis-scale such files ~1e9x
            unit = "ns"
        else:
            unit = "s"  # our harness emits seconds
        rec = out.setdefault(family, {
            "time": None, "unit": unit,
            "samples": [], "paths_per_second": None,
        })
        agg = b.get("aggregate_name")
        is_sample = (b.get("run_type") == "iteration"
                     or "repetition_index" in b
                     or (agg is None and name == family
                         and "real_time_median" not in b))
        t = b.get("real_time")
        if is_sample and t is not None:
            rec["samples"].append(float(t))
        if agg == "median" or "real_time_median" in b:
            rec["time"] = float(b.get("real_time_median", t))
        elif (agg is None and not is_sample and rec["time"] is None
                and t is not None):
            # a plain single entry (no repetitions, no aggregates)
            rec["time"] = float(t)
        if b.get("paths_per_second") is not None:
            rec["paths_per_second"] = b["paths_per_second"]
        if "repetition_samples" in b:  # our benchmark-google output
            rec["samples"].extend(float(x) for x in
                                  b["repetition_samples"])
    # normalize everything to SECONDS: Google Benchmark defaults to
    # nanoseconds while our harness emits seconds — comparing raw numbers
    # across units would produce ~1e9x-wrong speedups and unit-driven
    # U-test "significance"
    _TO_S = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}
    for fam, rec in list(out.items()):
        k = _TO_S.get(rec["unit"])
        if k is None:
            raise SystemExit(
                f"{path!r}: unknown time_unit {rec['unit']!r} for {fam!r}"
            )
        if rec["time"] is not None:
            rec["time"] *= k
        rec["samples"] = [x * k for x in rec["samples"]]
        rec["unit"] = "s"
        if rec["time"] is None and rec["samples"]:
            srt = sorted(rec["samples"])
            rec["time"] = srt[len(srt) // 2]
        if rec["time"] is None:
            # aggregate-only entry with no usable median/samples — report
            # and drop rather than crash formatting None later
            print(f"note: {fam!r} in {path!r} has no usable timing; "
                  "skipped")
            del out[fam]
    if not out:
        raise SystemExit(f"{path!r} has no benchmarks")
    return out


PLOT_METRICS = (
    "real_time",
    "cpu_time",
    "bytes_per_second",
    "items_per_second",
    "paths_per_second",
    "iterations",
)
PLOT_TRANSFORMS = ("", "inverse")


def _plot_rows(path: str, metric: str):
    """[(label, input_size, value)] from one benchmark JSON or CSV file.

    Mirrors the reference plotter's data model
    (python/benchmark_compare.py:96-123): the benchmark name splits on
    '/' into a curve label and an integer input size (size 1 when the
    name has no '/'). Aggregate entries (_mean/_median/...) are skipped
    so repeated runs don't double-plot.
    """
    rows = []
    if path.endswith(".csv"):
        import csv as _csv

        with open(path, newline="") as f:
            for r in _csv.DictReader(f):
                if metric not in r or r.get("name") is None:
                    raise SystemExit(
                        f"{path!r}: csv lacks 'name'/{metric!r} columns"
                    )
                rows.append((r["name"], float(r[metric])))
    else:
        with open(path) as f:
            data = json.load(f)
        for b in data.get("benchmarks", []):
            if b.get("aggregate_name"):
                continue
            if metric not in b:
                continue
            rows.append((b.get("name", "?"), float(b[metric])))
    if not rows:
        raise SystemExit(f"{path!r} has no entries with metric {metric!r}")
    out = []
    for name, v in rows:
        parts = name.split("/")
        label = parts[0]
        size = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 1
        out.append((label, size, v))
    return out


def plot_metric(path: str, metric: str = "real_time", transform: str = "",
                relative_to: Optional[str] = None, logx: bool = False,
                logy: bool = False, xlabel: str = "input size",
                ylabel: Optional[str] = None, title: str = "",
                output: Optional[str] = None):
    """Reference-parity metric plotter (python/benchmark_compare.py:39-163):
    one curve per label over input size, optional 1/x transform, optional
    normalization by the ``relative_to`` label's curve, log axes."""
    if metric not in PLOT_METRICS:
        raise SystemExit(
            f"unknown metric {metric!r}; choices: {', '.join(PLOT_METRICS)}"
        )
    if transform not in PLOT_TRANSFORMS:
        raise SystemExit(
            f"unknown transform {transform!r}; choices: '', 'inverse'"
        )
    rows = _plot_rows(path, metric)
    if transform == "inverse":
        rows = [(lbl, size, 1.0 / v) for lbl, size, v in rows]
    # A file produced with --benchmark_repetitions has several iteration
    # entries per (label, size); average them so the curve shows the
    # aggregate, not whichever repetition happened to be last in the file.
    acc: Dict[str, Dict[int, list]] = {}
    for lbl, size, v in rows:
        acc.setdefault(lbl, {}).setdefault(size, []).append(v)
    groups: Dict[str, Dict[int, float]] = {
        lbl: {s: sum(vs) / len(vs) for s, vs in g.items()}
        for lbl, g in acc.items()
    }
    if relative_to is not None:
        base = groups.get(relative_to)
        if base is None:
            raise SystemExit(
                f"label {relative_to!r} is not present in the benchmark "
                f"output (labels: {', '.join(sorted(groups))})"
            )
        base = dict(base)
        groups = {
            lbl: {s: v / base[s] for s, v in g.items() if s in base}
            for lbl, g in groups.items()
        }
    if ylabel is None:
        ylabel = metric if not transform else f"{transform}({metric})"
        if relative_to is not None:
            ylabel += f" relative to {relative_to}"

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for lbl in sorted(groups):
        pts = sorted(groups[lbl].items())
        ax.plot([s for s, _ in pts], [v for _, v in pts],
                marker=".", label=lbl)
    if logx:
        ax.set_xscale("log")
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    if output:
        fig.savefig(output)
        print(f"saved {output}")
    plt.close(fig)
    return groups


def compare_files(baseline_path: str, contender_path: str,
                  plot_path: Optional[str] = None, alpha: float = 0.05):
    base = _load(baseline_path)
    cont = _load(contender_path)
    names = sorted(set(base) | set(cont))
    rows = []
    print(f"{'benchmark':36s} {'baseline':>12s} {'contender':>12s} "
          f"{'speedup':>8s} {'p(U)':>8s}")
    for n in names:
        b = base.get(n)
        c = cont.get(n)
        if b is None or c is None:
            bt = "--" if b is None else f"{b['time']:.4f}"
            ct = "--" if c is None else f"{c['time']:.4f}"
            print(f"{n:36s} {bt:>12s} {ct:>12s} {'--':>8s} {'--':>8s}")
            continue
        speedup = b["time"] / c["time"] if c["time"] else float("inf")
        p_txt, p_val = "--", None
        if len(b["samples"]) >= 2 and len(c["samples"]) >= 2:
            _, p_val = mann_whitney_u(b["samples"], c["samples"])
            mark = "*" if p_val < alpha else " "
            p_txt = f"{p_val:.4f}{mark}"
        rows.append((n, b["time"], c["time"], speedup, p_val))
        print(f"{n:36s} {b['time']:>10.4f}{b['unit']:>2s} "
              f"{c['time']:>10.4f}{c['unit']:>2s} {speedup:>7.2f}x "
              f"{p_txt:>8s}")
    if rows and any(r[4] is not None for r in rows):
        print(f"(* = distributions differ at alpha={alpha}, "
              "Mann-Whitney U two-sided)")

    if plot_path and rows:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        names_, bt, ct, speedups, _ = zip(*rows)
        x = range(len(rows))
        fig, (ax, axr) = plt.subplots(
            2, 1, figsize=(10, 8), height_ratios=[2, 1], sharex=True
        )
        ax.bar([i - 0.2 for i in x], bt, width=0.4, label="baseline")
        ax.bar([i + 0.2 for i in x], ct, width=0.4, label="contender")
        ax.set_ylabel("time")
        ax.legend()
        # relative-to-baseline panel (benchmark_compare.py:103-143)
        rel = [c / b if b else float("nan") for b, c in zip(bt, ct)]
        axr.bar(list(x), rel, color="#888888")
        axr.axhline(1.0, color="k", lw=1)
        axr.set_ylabel("contender / baseline")
        axr.set_xticks(list(x))
        axr.set_xticklabels(names_, rotation=30, ha="right")
        plt.tight_layout()
        plt.savefig(plot_path)
        print(f"saved {plot_path}")
    return rows
