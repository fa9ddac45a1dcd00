"""Live visualization — the GUI-replacement surface (the port's copy of
``stock_market_monte_carlo_tpu/viz/live.py``; the runs go through the
port's engine on ``EngineOptions.device``).

The reference couples a simulation thread to a DearImGui/ImPlot render loop
polling an atomic counter and redrawing trajectories/quartiles/count-below
*while the simulation runs*, recomputing on target-slider change
(examples/visualize_returns_cpu.cpp:296-434, 340-356; two-thread variant
visualize_returns_cpu_v2.cpp:184-202). Here the equivalents are:

- :class:`LiveDashboard` — an ANSI terminal panel redrawn from every
  :class:`~stock_market_monte_carlo_torch.engine.engine.StreamUpdate` the
  engine pushes after each absorbed device chunk: progress/rate/ETA (the
  GUI's counter+FPS text), exact accumulated mean/std/min/max, histogram
  quantiles, P(below target), and a unicode final-value histogram that
  fills in as paths accumulate. Because every frame carries the exact
  on-device histogram, the stats are *true partial statistics*, not a
  sample — something the reference GUI only approximates from block means
  (visualize_returns_distribution_gpu_reduceBlock.cpp:183-186 admits its
  histogram "isn't correct").
- :func:`query_loop` — the target slider without the window: type any
  amount after the run and P(final < amount) / quantiles are recomputed
  instantly from the retained histogram.
- a capped trajectory run (the reference's max_n_visualisation trick)
  renders a fan chart with target line and final-value histogram to PNG.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

_BLOCKS = " ▁▂▃▄▅▆▇█"


def unicode_histogram(counts: np.ndarray, width: int = 56) -> str:
    """Down-bin counts to ``width`` columns of 8-level block characters."""
    counts = np.asarray(counts, np.float64)
    if counts.size == 0 or counts.sum() == 0:
        return " " * width
    k = max(1, int(np.ceil(counts.size / width)))
    pad = (-counts.size) % k
    cols = np.pad(counts, (0, pad)).reshape(-1, k).sum(axis=1)
    peak = cols.max()
    levels = np.ceil(cols / peak * 8).astype(int) if peak > 0 else cols
    return "".join(_BLOCKS[v] for v in np.clip(levels, 0, 8))


def trim_histogram(hist, spec):
    """(interior_counts[lo:hi], edges[lo:hi+1]) over the occupied bin
    range, or (None, None) if no mass — the spec brackets +/-12 sigma so
    realized mass covers a small slice of it. Shared by the dashboard,
    the query loop and the PNG renderer."""
    interior = np.asarray(hist)[1:-1]
    nz = np.nonzero(interior)[0]
    if not nz.size:
        return None, None
    lo_b, hi_b = int(nz[0]), int(nz[-1]) + 1
    edges = spec.edges()
    return interior[lo_b:hi_b], edges[lo_b:hi_b + 1]


def downsample_histogram(counts, edges, target: int = 128):
    """(counts_d, edges_d): k-group the bins down to <= ``target``
    columns, PADDING the tail group rather than truncating it (dropping
    it always lost the highest occupied bin, which is nonzero by
    construction of trim_histogram). Shared by the interactive query
    loop and the live-fan PNG renderer so the decimation rule cannot
    drift between them."""
    k = max(1, len(counts) // target)
    pad = (-len(counts)) % k
    counts_d = np.pad(counts, (0, pad)).reshape(-1, k).sum(axis=1)
    edges_d = np.append(edges[::k][: len(counts_d)], edges[-1])
    return counts_d, edges_d


class LiveDashboard:
    """Terminal stream renderer: pass as ``stream=`` to the engine.

    On a TTY the panel redraws in place (cursor-up rewrite); on plain
    streams each frame is appended, throttled by ``min_interval_s``
    (the final frame always renders).
    """

    QS = (0.05, 0.25, 0.5, 0.75, 0.95)

    def __init__(self, out=None, width: int = 56,
                 min_interval_s: float = 0.25):
        self.out = out if out is not None else sys.stdout
        self.width = width
        self.min_interval = min_interval_s
        self._last_t = -1.0
        self._lines_drawn = 0
        self.frames = 0
        self.last_update = None

    def __call__(self, update) -> None:
        self.last_update = update
        final = update.done >= update.n_paths
        if not final and update.elapsed_s - self._last_t < self.min_interval:
            return
        self._last_t = update.elapsed_s
        self._render(update)

    def _render(self, u) -> None:
        lines = self._frame_lines(u)
        out = self.out
        if self._lines_drawn and getattr(out, "isatty", lambda: False)():
            out.write(f"\x1b[{self._lines_drawn}A")  # cursor up: redraw
        for ln in lines:
            out.write("\x1b[2K" + ln + "\n"
                      if getattr(out, "isatty", lambda: False)()
                      else ln + "\n")
        self._lines_drawn = len(lines)
        self.frames += 1
        out.flush()

    def _frame_lines(self, u) -> list:
        frac = u.done / max(u.n_paths, 1)
        filled = int(round(frac * 24))
        bar = "█" * filled + "░" * (24 - filled)
        rate = u.done / max(u.elapsed_s, 1e-9)
        eta = (u.n_paths - u.done) / max(rate, 1e-9)
        m = u.moments
        lines = [
            f"paths {bar} {100 * frac:5.1f}%  {u.done:,} / {u.n_paths:,}"
            f"  {rate / 1e6:,.0f}M paths/s  ETA {eta:.1f}s",
            f"mean {m.mean:,.2f}   std {m.std:,.2f}   "
            f"min {m.min:,.2f}   max {m.max:,.2f}",
        ]
        if u.done > 0 and u.hist.sum() > 0:
            # histogram=False runs stream without counts — skip the
            # quantile row rather than crashing the run mid-stream
            q = u.quantiles(self.QS)
            lines.append("   ".join(
                f"p{int(100 * p):02d} {v:,.1f}" for p, v in zip(self.QS, q)
            ))
        if u.target_amount is not None and m.count_below is not None:
            pct = 100.0 * m.count_below / max(u.done, 1)
            lines.append(
                f"P(final < {u.target_amount:,.1f}) = {pct:.4f}%"
                f"   (count {m.count_below:,})"
            )
        counts, edges = trim_histogram(u.hist, u.spec)
        if counts is not None:
            lines.append(
                f"hist  {unicode_histogram(counts, self.width)}"
                f"  [{edges[0]:,.0f} .. {edges[-1]:,.0f}]"
            )
        return lines


class ResultQuery:
    """Adapter exposing a finished SimulationResult through the interface
    query_loop expects (done/hist/spec/moments/quantiles/prob_below), so
    --interactive works with --no-live too."""

    def __init__(self, result):
        self._res = result
        self.done = result.n_paths
        self.hist = np.asarray(result.histogram_counts, np.float64)
        self.spec = result.histogram_spec
        self.moments = result.moments

    def quantiles(self, qs):
        from stock_market_monte_carlo_torch.ops.reductions import (
            quantiles_from_histogram,
        )

        return quantiles_from_histogram(self.spec, self.hist, qs)

    def prob_below(self, amount: float) -> float:
        return self._res.prob_below_amount(amount)


_QUERY_HELP = (
    "commands: <amount> -> P(final < amount) | q <p> -> quantile "
    "(e.g. q 0.95) | hist -> histogram | stats -> summary | quit"
)


def query_loop(update, inp=None, out=None) -> None:
    """Interactive result exploration — the reference GUI's sliders
    (target recompute visualize_returns_cpu.cpp:340-356, histogram toggle
    visualize_returns_gpu.cpp:344-357) as a prompt over the exact
    retained statistics; every answer is recomputed from the on-device
    histogram, no re-simulation."""
    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    out.write(_QUERY_HELP + "\n> ")
    out.flush()
    for line in inp:
        s = line.strip().lower()
        if s in ("q", "quit", "exit", ""):
            break
        if s in ("h", "help", "?"):
            out.write(_QUERY_HELP + "\n")
        elif s == "hist":
            counts, edges = trim_histogram(update.hist, update.spec)
            if counts is not None:
                out.write(
                    f"{unicode_histogram(counts)}  "
                    f"[{edges[0]:,.0f} .. {edges[-1]:,.0f}]\n"
                )
            else:
                out.write("(empty histogram)\n")
        elif s == "stats":
            m = update.moments
            out.write(
                f"n {update.done:,}  mean {m.mean:,.2f}  std {m.std:,.2f}"
                f"  min {m.min:,.2f}  max {m.max:,.2f}"
                f"  skew {m.skew:.3f}  kurt {m.kurtosis:.3f}\n"
            )
        elif s.startswith("q "):
            try:
                p = float(s[2:])
                if not 0.0 < p < 1.0:
                    raise ValueError
            except ValueError:
                out.write(f"quantile must be in (0,1): {s[2:]!r}\n")
            else:
                try:
                    v = update.quantiles([p])[0]
                except ValueError as e:
                    out.write(f"{e}\n")
                else:
                    out.write(f"p{100 * p:g} = {v:,.2f}\n")
        else:
            try:
                amount = float(s)
            except ValueError:
                out.write(f"not a number: {s!r}\n")
            else:
                try:
                    p = update.prob_below(amount)
                except ValueError as e:
                    out.write(f"{e}\n")
                else:
                    out.write(
                        f"P(final < {amount:,.2f}) = {100 * p:.4f}%  "
                        f"(~{int(round(p * update.done)):,} of "
                        f"{update.done:,})\n"
                    )
        out.write("> ")
        out.flush()
    out.write("\n")


def live_visualize(n_months: int, n_simulations: int,
                   model_kind: str = "historical", target: float = 1000.0,
                   seed: int = 0, n_curves: int = 100,
                   save: Optional[str] = None,
                   show: bool = False,
                   overlay_normal: bool = False,
                   live: bool = True,
                   interactive: Optional[bool] = None,
                   stream_out=None,
                   live_fan: Optional[str] = None,
                   fan_frames: Optional[str] = None,
                   gui: bool = False,
                   options=None):
    """``overlay_normal`` adds the CLT normal-pdf curve over the exact
    final-value histogram — what the reference's
    visualize_returns_distribution_gpu_reduceBlock GUI attempted from block
    stats (its header admits "histogram/statistics aren't correct",
    examples/...cpp:183-186); here both the histogram and the overlay are
    exact on-device statistics.

    ``live=True`` attaches a :class:`LiveDashboard` that redraws exact
    partial statistics while the run streams; ``interactive`` (default:
    auto when stdin is a TTY) opens the target re-query prompt afterwards.
    ``live_fan`` additionally renders the GRAPHICAL fan + histogram to a
    PNG refreshed during the run (the reference GUI's during-run plot,
    visualize_returns_cpu.cpp:372-404 — see viz/live_fan.py); ``fan_frames``
    also collects numbered frame files.

    ``gui=True`` opens the interactive WINDOW (viz/gui.InteractiveWindow):
    live fan + exact-partial histogram redrawn during the run and a
    target-amount slider recomputing P(final < target) from the retained
    histogram on change — the reference's flagship ImGui form
    (visualize_returns_cpu.cpp:296-434, slider recompute :340-356). On a
    GUI-less matplotlib backend (Agg) the window is built and fully
    functional for programmatic events but never blocks.

    ``options`` (default ``EngineOptions()``, the card) is the run's and
    the drawn trajectories' engine options.
    """
    import stock_market_monte_carlo_torch as smmc
    from stock_market_monte_carlo_torch.viz.plots import fan_chart

    if options is None:
        options = smmc.EngineOptions()
    if model_kind == "historical":
        model = smmc.HistoricalBootstrap.from_csv()
    else:
        model = smmc.GaussianReturns()

    dashboard = LiveDashboard(out=stream_out) if live else None
    fan = None
    if live_fan:
        from stock_market_monte_carlo_torch.viz.live_fan import LiveFanFigure

        fan = LiveFanFigure(
            model, n_months, initial_capital=1000.0, seed=seed,
            target=target, n_curves=min(n_curves, n_simulations),
            out_path=live_fan, frames_dir=fan_frames, options=options,
        )
    window = None
    if gui:
        from stock_market_monte_carlo_torch.viz.gui import InteractiveWindow

        window = InteractiveWindow(
            model, n_months, initial_capital=1000.0, seed=seed,
            target=target, n_curves=min(n_curves, n_simulations),
            options=options,
        )
    consumers = [c for c in (dashboard, fan, window) if c is not None]
    if len(consumers) > 1:
        from stock_market_monte_carlo_torch.viz.live_fan import FanoutStream

        stream = FanoutStream(*consumers)
    else:
        stream = consumers[0] if consumers else None
    progress = None
    if not consumers:
        from stock_market_monte_carlo_torch.engine.progress import (
            TerminalProgress,
        )

        progress = TerminalProgress()

    res = smmc.run(
        model, n_simulations, n_months, initial_capital=1000.0, seed=seed,
        target_amount=target, options=options, progress=progress,
        stream=stream, keep_trajectories=min(n_curves, n_simulations),
    )
    if fan is not None:
        print(f"live fan: {fan.frames} frames rendered to {live_fan}"
              + (f" (+ {fan_frames}/)" if fan_frames else ""))
        fan.close()
    print(res.summary())
    if window is not None:
        # blocking on a GUI backend; headless (Agg) returns immediately
        # with the window fully built for programmatic interaction
        window.show()

    # trim the histogram to its occupied range, then decimate; pad the
    # tail group instead of truncating it (dropping it always lost the
    # highest-value bin, which is nonzero by construction of the trim)
    counts, edges = trim_histogram(res.histogram_counts,
                                   res.histogram_spec)
    if counts is None:
        counts = np.zeros((1,), np.float64)
        edges = res.histogram_spec.edges()[:2]
    counts_d, edges_d = downsample_histogram(counts, edges)
    normal_curve = None
    if overlay_normal:
        import torch

        from stock_market_monte_carlo_torch.ops.normal import normal_pdf

        centers = 0.5 * (edges_d[:-1] + edges_d[1:])
        widths = np.diff(edges_d)
        pdf = normal_pdf(torch.as_tensor(centers, dtype=torch.float32,
                                         device=options.device),
                         res.mean, res.std).cpu().numpy()
        normal_curve = (centers, pdf * res.n_paths * widths)

    save = save or "visualize_returns.png"
    traj = (np.asarray(res.trajectories)
            if res.trajectories is not None
            else np.zeros((0, n_months + 1), np.float32))
    fan_chart(
        traj, target=target,
        histogram=(edges_d, counts_d), save=save,
        title=(f"{model_kind} MC: {n_simulations} sims x {n_months} months "
               f"(drawing {traj.shape[0]})"),
        show=show, normal_curve=normal_curve,
    )
    if interactive is None:
        interactive = sys.stdin.isatty()
    if interactive:
        if dashboard is not None and dashboard.last_update is not None:
            query_loop(dashboard.last_update)
        else:
            query_loop(ResultQuery(res))
    return res
