"""Interactive graphical window — the reference's flagship GUI form (the
port's copy of ``stock_market_monte_carlo_tpu/viz/gui.py``).

The reference's ImGui apps open a live window: trajectories appear as the
simulation thread fills buffers, a histogram panel tracks final values,
and a target-amount slider recomputes P(final < target) on change from
the retained results (examples/visualize_returns_cpu.cpp:296-434; the
recompute-on-change caching at :340-356). This module is that form
factor on matplotlib widgets:

- :class:`InteractiveWindow` is an engine ``stream=`` consumer: every
  absorbed chunk redraws the fan (incremental capped trajectory batches,
  the reference's two-thread keepdata-for-drawing trick,
  visualize_returns_cpu_v2.cpp:184-202) and the EXACT partial final-value
  histogram + stats (the reference polls shared buffers; here the stream
  update IS the exact accumulated state).
- A matplotlib ``Slider`` drives the target amount: on change,
  P(final < target) and the failure count are recomputed from the exact
  retained histogram — no re-simulation, same capability as the
  reference's slider (visualize_returns_cpu.cpp:340-356) but over exact
  statistics instead of a stored sample.

Headless-testable by design: on the Agg backend the window never blocks,
and ``slider.set_val(x)`` fires the same ``on_changed`` callback a mouse
drag does — tests/test_torch_viz.py drives a slider change
programmatically and asserts the recomputed probability against the
histogram oracle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class InteractiveWindow:
    """Live fan + exact-partial histogram + target slider in one window.

    Pass as (or inside) ``stream=`` to :func:`smmc.run`; afterwards call
    :meth:`show` to hand control to the window's event loop (no-op on a
    non-interactive backend such as Agg). The slider works during the
    run and after it — every change recomputes from the newest exact
    partial statistics.
    """

    def __init__(self, model, n_periods: int,
                 initial_capital: float = 1000.0, seed: int = 0,
                 strategy=None, target: float = 1000.0,
                 n_curves: int = 100, curves_per_frame: int = 10,
                 min_interval_s: float = 0.25, options=None):
        from stock_market_monte_carlo_torch.config import EngineOptions
        from stock_market_monte_carlo_torch.models.strategies import (
            NoWithdrawal,
        )

        # the drawn trajectories' engine options (their device)
        self.options = options if options is not None else EngineOptions()
        self.model = model
        self.n_periods = n_periods
        self.initial_capital = initial_capital
        self.seed = seed
        self.strategy = strategy if strategy is not None else NoWithdrawal()
        self.target = float(target)
        self.n_curves = n_curves
        self.curves_per_frame = curves_per_frame
        self.min_interval = min_interval_s
        self.curves_done = 0
        self.frames = 0
        self.last_update = None
        self.slider = None
        self._last_t = -1.0
        self._fig = None

    # ------------------------------------------------------------------
    # figure construction
    # ------------------------------------------------------------------

    def _ensure_fig(self):
        if self._fig is not None:
            return
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        self._plt = plt
        self._fig = plt.figure(figsize=(14, 7.5))
        gs = self._fig.add_gridspec(
            2, 2, width_ratios=[3, 1], height_ratios=[14, 1],
            hspace=0.3,
        )
        self._ax = self._fig.add_subplot(gs[0, 0])
        self._axh = self._fig.add_subplot(gs[0, 1])
        self._axs = self._fig.add_subplot(gs[1, :])
        self._ax.set_xlabel("Month")
        self._ax.set_ylabel("Fund value")
        self._ax.axhline(self.initial_capital, color="k", linewidth=1,
                         label="initial capital")
        self._target_line = self._ax.axhline(
            self.target, color="r", linewidth=1.5, linestyle="--",
            label="target amount",
        )
        self._target_line_h = self._axh.axhline(
            self.target, color="r", linewidth=1.0, linestyle="--",
        )
        self._ax.legend(loc="upper left", fontsize=8)
        self._prob_text = self._fig.text(
            0.01, 0.005, "", fontsize=10, family="monospace",
        )
        # slider range: generous multiple of the initial capital so both
        # ruin-ish and growth targets are reachable; the reference's
        # slider is likewise a fixed generous range
        # (visualize_returns_cpu.cpp:340-356)
        hi = max(4.0 * self.target, 10.0 * self.initial_capital)
        self.slider = Slider(
            self._axs, "target", 0.0, hi, valinit=self.target,
            valstep=hi / 1000.0,
        )
        self.slider.on_changed(self._on_target_change)

    # ------------------------------------------------------------------
    # streaming consumer (during the run)
    # ------------------------------------------------------------------

    def _add_curves(self, k: int) -> None:
        if k <= 0:
            return
        from stock_market_monte_carlo_torch.engine.engine import (
            simulate_paths,
        )

        # counter-based RNG: path_offset yields exactly rows
        # [curves_done, curves_done+k) of the drawing stream — each
        # frame computes and transfers only its new curves
        traj = simulate_paths(
            self.model, k, self.n_periods, self.initial_capital,
            self.seed, self.strategy, path_offset=self.curves_done,
            options=self.options,
        )
        self._ax.plot(traj.T, linewidth=0.7)
        self.curves_done += k

    def __call__(self, update) -> None:
        final = update.done >= update.n_paths
        if (not final
                and update.elapsed_s - self._last_t < self.min_interval):
            return
        self._last_t = update.elapsed_s
        self._ensure_fig()
        self.last_update = update

        want = self.n_curves if final else min(
            self.n_curves, self.curves_done + self.curves_per_frame
        )
        self._add_curves(want - self.curves_done)
        self._redraw_hist(update)
        self._update_prob_text()

        m = update.moments
        pct = 100.0 * update.done / max(update.n_paths, 1)
        self._ax.set_title(
            f"{update.done:,} / {update.n_paths:,} paths ({pct:.1f}%)   "
            f"mean {m.mean:,.1f}   std {m.std:,.1f}"
        )
        self.frames += 1
        self._pump()

    def _redraw_hist(self, update) -> None:
        from stock_market_monte_carlo_torch.viz.live import (
            downsample_histogram,
            trim_histogram,
        )

        self._axh.cla()
        counts, edges = trim_histogram(update.hist, update.spec)
        if counts is not None:
            cd, ed = downsample_histogram(counts, edges)
            centers = 0.5 * (ed[:-1] + ed[1:])
            self._axh.barh(centers, cd, height=np.diff(ed))
        self._target_line_h = self._axh.axhline(
            self.target, color="r", linewidth=1.0, linestyle="--",
        )
        self._axh.set_xlabel("paths")
        self._axh.set_title("final values (exact partial)")

    def _pump(self) -> None:
        """Draw; on an interactive backend also run the event loop a
        tick so the window stays responsive mid-run (the reference's
        render loop runs concurrently with the sim thread — matplotlib
        gets its ticks from inside the stream callback instead)."""
        self._fig.canvas.draw_idle()
        if self._plt.isinteractive() or self._backend_is_gui():
            try:
                self._fig.canvas.flush_events()
                self._plt.pause(0.001)
            except Exception:
                pass  # backends without an event loop (Agg) need none

    def _backend_is_gui(self) -> bool:
        import matplotlib

        return matplotlib.get_backend().lower() not in (
            "agg", "pdf", "svg", "ps", "template",
        )

    # ------------------------------------------------------------------
    # the slider: recompute-on-change from retained exact statistics
    # ------------------------------------------------------------------

    def _on_target_change(self, val) -> None:
        self.target = float(val)
        self._target_line.set_ydata([self.target, self.target])
        if self.last_update is not None:
            self._redraw_hist(self.last_update)
        self._update_prob_text()
        self._fig.canvas.draw_idle()

    def prob_below_target(self) -> Optional[float]:
        """P(final < target) over the paths done so far, recomputed from
        the exact retained histogram (None before the first update)."""
        if self.last_update is None or self.last_update.done == 0:
            return None
        from stock_market_monte_carlo_torch.ops.reductions import (
            prob_below_from_histogram,
        )

        u = self.last_update
        return prob_below_from_histogram(u.spec, u.hist, self.target)

    def _update_prob_text(self) -> None:
        p = self.prob_below_target()
        if p is None:
            self._prob_text.set_text("waiting for first results ...")
            return
        u = self.last_update
        try:
            qs = u.quantiles((0.05, 0.5, 0.95))
            qtxt = (f"   p05 {qs[0]:,.1f}  p50 {qs[1]:,.1f}  "
                    f"p95 {qs[2]:,.1f}")
        except ValueError:
            qtxt = ""
        self._prob_text.set_text(
            f"P(final < {self.target:,.1f}) = {100.0 * p:.4f}%  "
            f"(~{int(round(p * u.done)):,} of {u.done:,}){qtxt}"
        )

    # ------------------------------------------------------------------

    def show(self) -> None:
        """Hand control to the window (blocking) on a GUI backend; no-op
        headless so scripted/CI runs terminate."""
        if self._fig is None:
            return
        self._update_prob_text()
        if self._backend_is_gui():
            self._plt.show()

    def close(self) -> None:
        if self._fig is not None:
            self._plt.close(self._fig)
            self._fig = None
