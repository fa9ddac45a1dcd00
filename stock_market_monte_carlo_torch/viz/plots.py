"""Matplotlib plotting — the analysis surface of the framework (the port's
copy of ``stock_market_monte_carlo_tpu/viz/plots.py``; the PRNG and normal
curves computed with torch on ``device``).

Ports the capabilities of python/plot_returns.py (single-simulation plots,
many-simulation fan + violin overviews with HDF5 export) and the two ImGui
demo visualizers (visualize_rng's PRNG histograms, visualize_distribution's
normal pdf/cdf curves) onto matplotlib. All functions save PNGs (and
optionally show) so they work headless. matplotlib is imported at the
first plot; without it a plot raises ImportError.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the plots need matplotlib, which this Python lacks; the "
            "simulations themselves do not") from e

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _card(device):
    """``device`` as a torch device; refuses a card torch cannot find."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: torch finds no CUDA device; pass "
            "device='cpu' to draw on the CPU")
    return dev


def plot_returns_csv(csv_file: str, save: Optional[str] = None,
                     show: bool = False):
    """Plot one simulation CSV (ref: plot_returns.py:125-150 writes
    values.png and monthly_returns.png next to the CSV)."""
    from stock_market_monte_carlo_torch.utils.io import read_data_file

    plt = _plt()
    returns, values = read_data_file(csv_file)
    dirpth = os.path.dirname(csv_file) or "."
    print(f"Final value:  {values[-1]}")

    plt.figure()
    plt.plot(values)
    plt.title("Fund value over time")
    plt.xlabel("Time (Months)")
    plt.ylabel("Fund value")
    plt.tight_layout()
    out1 = save or os.path.join(dirpth, "values.png")
    plt.savefig(out1)

    plt.figure()
    plt.plot(returns)
    plt.title("Monthly Returns over time")
    plt.xlabel("Time (Months)")
    plt.ylabel("Monthly return")
    plt.tight_layout()
    if save:
        # honor --save for BOTH figures: the returns plot goes next to
        # the user's chosen path, not next to the (possibly read-only)
        # input CSV
        base, ext = os.path.splitext(save)
        out2 = f"{base}_returns{ext or '.png'}"
    else:
        out2 = os.path.join(dirpth, "monthly_returns.png")
    plt.savefig(out2)
    print(f"saved {out1} and {out2}")
    if show:
        plt.show()
    plt.close("all")


def plot_many_returns_dir(dir: str = "outputs/", max_n: int = 1000,
                          pick_random: bool = True,
                          inflation_percent: float = 0.0,
                          save: Optional[str] = None, show: bool = False,
                          seed: int = 0):
    """Fan chart + total/annualized return violins over a directory of
    simulation CSVs (ref: plot_returns.py:15-121). Also writes the
    trajectory matrix to ``store.h5`` like the reference's HDFStore when an
    HDF5 backend is available."""
    from stock_market_monte_carlo_torch.utils.io import read_data_file

    plt = _plt()
    files = sorted(f for f in os.listdir(dir) if f.endswith(".csv"))
    if len(files) > max_n:
        print("more simulation files than 'max_n' argument, subsampling!")
        rng = np.random.default_rng(seed)
        if pick_random:
            files = list(rng.choice(files, size=max_n, replace=False))
        else:
            files = files[:max_n]
    n_simulations = len(files)
    if n_simulations == 0:
        raise SystemExit(f"no CSV files in {dir!r}")

    print("Reading csv output files...")
    series = []
    for f in sorted(files):
        _, values = read_data_file(os.path.join(dir, f))
        series.append(values)
    lengths = {len(v) for v in series}
    if len(lengths) != 1:
        raise SystemExit(f"inconsistent trajectory lengths: {lengths}")
    data = np.stack(series)  # (n, months+1)

    finals = data[:, -1]
    initial_capital = float(data[0, 0])
    print(f"Mean capital value:    {finals.mean()}")
    print(f"Maximum capital value: {finals.max()} "
          f"(simulation {int(finals.argmax())})")
    print(f"Minimum capital value: {finals.min()} "
          f"(simulation {int(finals.argmin())})")

    _write_h5(dir, data)

    # fan chart
    fig, ax = plt.subplots(figsize=(16, 10))
    ax.plot(data.T, linewidth=0.8)
    ax.plot([initial_capital] * data.shape[1], label="Starting amount",
            color="r", linewidth=5)
    ax.set_title(f"Fund value over time (N={n_simulations})")
    ax.set_xlabel("Time (Months)")
    ax.set_ylabel("Fund value")
    if n_simulations < 20:
        ax.legend()
    plt.tight_layout()
    out1 = save or os.path.join(dir, "MC_capital_overview.png")
    plt.savefig(out1)

    # inflation-adjusted failure count (ref: plot_returns.py:73-79)
    n_years = (data.shape[1] - 1) / 12
    min_amount = initial_capital * (1 + inflation_percent / 100.0) ** n_years
    count_bad = int(np.sum(finals < min_amount))
    print(
        f"Out of {n_simulations} simulations, {count_bad} ended up with "
        f"less than the initial amount corrected for inflation of "
        f"{inflation_percent}%"
    )

    # violin plots of total/annualized returns with bold quartile ticks
    total_returns = finals / data[:, 0] - 1.0
    annual_returns = (1 + total_returns) ** (1 / n_years) - 1
    fig, axs = plt.subplots(nrows=1, ncols=2, figsize=(16, 10))
    for ax, rets, title in (
        (axs[0], 100 * total_returns, f"Total returns across {n_years} years"),
        (axs[1], 100 * annual_returns,
         f"Annualized returns across {n_years} years"),
    ):
        ax.violinplot(rets, showextrema=True)
        q = np.quantile(rets, [0.25, 0.5, 0.75])
        for v in q:
            ax.axhline(v, color="k", linewidth=0.8, linestyle="--")
        ax.set_title(title)
        ax.set_ylabel("Return (%)")
        ax.set_yticks(list(ax.get_yticks()) + q.tolist())
    plt.tight_layout()
    out2 = os.path.join(dir, "MC_returns_overview.png")
    plt.savefig(out2)
    print(f"saved {out1} and {out2}")
    if show:
        plt.show()
    plt.close("all")
    return {"count_bad": count_bad, "mean": float(finals.mean())}


def _write_h5(dir, data):
    """HDF5 trajectory export (the reference writes store.h5 via pandas
    HDFStore, plot_returns.py:60-61; we use h5py directly)."""
    try:
        import h5py
    except ImportError:
        print("h5py unavailable; skipping store.h5 export")
        return
    path = os.path.join(dir, "store.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("trajectories", data=data, compression="gzip")
    print(f"saved trajectories to {path}")


def fan_chart(trajectories: np.ndarray, target: Optional[float] = None,
              histogram=None, save: Optional[str] = None,
              title: str = "Monte Carlo fund evolution", show: bool = False,
              normal_curve=None):
    """Trajectory fan + optional final-value histogram — the static render
    of the reference GUI's main plot (visualize_returns_cpu.cpp:372-404)."""
    plt = _plt()
    if histogram is not None:
        fig, (ax, axh) = plt.subplots(
            1, 2, figsize=(16, 8), width_ratios=[3, 1]
        )
    else:
        fig, ax = plt.subplots(figsize=(12, 8))
        axh = None
    ax.plot(trajectories.T, linewidth=0.7)
    if trajectories.shape[0]:  # curves may be disabled (--curves 0)
        ax.axhline(trajectories[0, 0], color="k", linewidth=1,
                   label="initial capital")
    if target is not None:
        ax.axhline(target, color="r", linewidth=1.5, linestyle="--",
                   label="target amount")
    ax.set_title(title)
    ax.set_xlabel("Month")
    ax.set_ylabel("Fund value")
    ax.legend()
    if axh is not None:
        edges, counts = histogram
        centers = 0.5 * (edges[:-1] + edges[1:])
        axh.barh(centers, counts, height=np.diff(edges))
        if normal_curve is not None:
            xs, ys = normal_curve
            axh.plot(ys, xs, color="k", linewidth=1.5,
                     label="normal (CLT) fit")
            axh.legend(fontsize=8)
        axh.set_xlabel("paths")
        axh.set_title("final values")
    plt.tight_layout()
    if save:
        plt.savefig(save)
        print(f"saved {save}")
    if show:
        plt.show()
    plt.close("all")


def rng_histograms(save: Optional[str] = None, n: int = 1 << 18,
                   show: bool = False, device="cuda"):
    """Uniformity histograms of the ported reference PRNGs
    (ref: visualize_rng.cpp:289-323 eyeballs xorshift/HybridTaus),
    drawn on ``device`` (the card unless the caller names the CPU)."""
    import torch

    from stock_market_monte_carlo_torch.ops import rng as r

    plt = _plt()
    device = _card(device)
    lanes = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    xorshift_u = r.uniform_from_bits(r.xorshift_stream(lanes, 1)[..., 0])
    state = torch.stack(
        [torch.clamp_min(r.pcg_hash(lanes + k * 7919), 128)
         for k in range(4)],
        dim=-1,
    )
    _, taus_u = r.hybrid_taus_step(state)
    pcg_u = r.uniform_from_bits(r.pcg_hash(lanes))

    fig, axs = plt.subplots(1, 3, figsize=(15, 4))
    for ax, (name, u) in zip(axs, [
        ("xorshift (pcg-seeded)", xorshift_u),
        ("HybridTaus", taus_u),
        ("pcg_hash", pcg_u),
    ]):
        u = u.cpu().numpy()
        ax.hist(u, bins=100, range=(0, 1))
        ax.axhline(len(u) / 100, color="r", linewidth=1)
        ax.set_title(name)
    plt.tight_layout()
    out = save or "rng_histograms.png"
    plt.savefig(out)
    print(f"saved {out}")
    if show:
        plt.show()
    plt.close("all")


def distribution_curves(mean: float = 0.0, std: float = 1.0,
                        save: Optional[str] = None, show: bool = False,
                        device="cuda"):
    """Normal pdf/cdf/inverse-cdf curves (ref: visualize_distribution.cpp:
    153-368 plots the math kit), computed on ``device`` (the card unless
    the caller names the CPU)."""
    import torch

    from stock_market_monte_carlo_torch.ops import normal as nm

    plt = _plt()
    device = _card(device)
    x = np.linspace(mean - 4 * std, mean + 4 * std, 512)
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    pdf = nm.normal_pdf(xt, mean, std).cpu().numpy()
    cdf = nm.normal_cdf(xt, mean, std).cpu().numpy()
    u = np.linspace(1e-4, 1 - 1e-4, 512)
    icdf = nm.normal_icdf(torch.as_tensor(u, dtype=torch.float32,
                                          device=device),
                          mean, std).cpu().numpy()

    fig, axs = plt.subplots(1, 3, figsize=(15, 4))
    axs[0].plot(x, pdf)
    axs[0].set_title(f"pdf N({mean}, {std}²)")
    axs[1].plot(x, cdf)
    axs[1].set_title("cdf")
    axs[2].plot(u, icdf)
    axs[2].set_title("inverse cdf")
    plt.tight_layout()
    out = save or "distribution_curves.png"
    plt.savefig(out)
    print(f"saved {out}")
    if show:
        plt.show()
    plt.close("all")


def band_chart(bands, target: Optional[float] = None,
               save: Optional[str] = None,
               title: str = "Monte Carlo percentile bands",
               show: bool = False):
    """Percentile-band plot from a TrajectoryBands result — the
    store-everything GUI fan (visualize_returns_cpu.cpp:372-382) for path
    counts where materializing trajectories is impossible; the bands are
    computed on device (engine/bands.py) and only O(T) crosses the host."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 7))
    months = bands.months
    levels = list(bands.quantile_levels)
    # shade symmetric band pairs, line for the median
    pairs = []
    rest = sorted(levels)
    while len(rest) >= 2:
        lo, hi = rest[0], rest[-1]
        pairs.append((lo, hi))
        rest = rest[1:-1]
    for i, (lo, hi) in enumerate(pairs):
        ax.fill_between(
            months, bands.band(lo), bands.band(hi),
            alpha=0.18 + 0.1 * i, color="C0",
            label=f"p{int(lo * 100):02d}-p{int(hi * 100):02d}",
        )
    for q in rest:
        ax.plot(months, bands.band(q), color="C0", lw=2,
                label=f"p{int(q * 100):02d}")
    for row in bands.sample_paths[:20]:
        ax.plot(months, row, lw=0.5, alpha=0.5, color="C1")
    if target is not None:
        ax.axhline(target, color="r", ls="--", lw=1, label="target")
    ax.set_xlabel("month")
    ax.set_ylabel("fund value")
    ax.set_title(f"{title} ({bands.n_paths:,} paths)")
    ax.legend(loc="upper left")
    fig.tight_layout()
    if save:
        d = os.path.dirname(save)
        if d:
            os.makedirs(d, exist_ok=True)
        fig.savefig(save)
        print(f"saved {save}")
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)
