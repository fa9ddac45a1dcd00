"""During-run graphical fan — the reference GUI's live trajectory plot
(the port's copy of ``stock_market_monte_carlo_tpu/viz/live_fan.py``).

The reference ImGui apps draw <= 100 trajectories incrementally while the
simulation thread fills buffers, next to a live final-value histogram
(examples/visualize_returns_cpu.cpp:372-404, render loop 296-434). This is
that capability for a headless environment: a matplotlib figure refreshed
to PNG after every absorbed engine chunk — the fan gains curves as the
run progresses and the histogram panel shows the EXACT partial final-value
counts (not a sample; the engine streams true accumulated statistics).
Point any auto-reloading image viewer at ``out_path``, or collect
numbered frames with ``frames_dir`` (an animation of the run).

Trajectories come from capped incremental ``simulate_paths`` batches —
the reference's own two-thread trick (a keepdata run of
max_n_visualisation paths just for drawing, next to the stats run;
visualize_returns_cpu_v2.cpp:184-202). Counter-based RNG makes the
incremental batches identical to one big call.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import numpy as np


class LiveFanFigure:
    """Streaming renderer: pass as (or inside) ``stream=`` to the engine.

    Every callback draws up to ``curves_per_frame`` new trajectories
    (until ``n_curves``), refreshes the histogram panel from the exact
    partial counts, and atomically replaces ``out_path``. The final
    callback always renders, with every remaining curve drawn.
    """

    def __init__(self, model, n_periods: int, initial_capital: float
                 = 1000.0, seed: int = 0, strategy=None,
                 target: Optional[float] = None, n_curves: int = 100,
                 out_path: str = "live_fan.png",
                 frames_dir: Optional[str] = None,
                 curves_per_frame: int = 10,
                 min_interval_s: float = 0.25,
                 options=None):
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
        self.target = target
        self.n_curves = n_curves
        self.out_path = out_path
        self.frames_dir = frames_dir
        self.curves_per_frame = curves_per_frame
        self.min_interval = min_interval_s
        self.curves_done = 0
        self.frames = 0
        self._last_t = -1.0
        self._fig = None

    def _ensure_fig(self):
        if self._fig is not None:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._fig, (self._ax, self._axh) = plt.subplots(
            1, 2, figsize=(14, 7), width_ratios=[3, 1]
        )
        self._ax.set_xlabel("Month")
        self._ax.set_ylabel("Fund value")
        self._ax.axhline(self.initial_capital, color="k", linewidth=1,
                         label="initial capital")
        if self.target is not None:
            self._ax.axhline(self.target, color="r", linewidth=1.5,
                             linestyle="--", label="target amount")
        self._ax.legend(loc="upper left", fontsize=8)
        if self.frames_dir:
            os.makedirs(self.frames_dir, exist_ok=True)

    def _add_curves(self, k: int) -> None:
        """Draw the next ``k`` trajectories (global paths
        [curves_done, curves_done+k) of the drawing stream)."""
        if k <= 0:
            return
        from stock_market_monte_carlo_torch.engine.engine import (
            simulate_paths,
        )

        # counter-based RNG: path_offset yields exactly the rows
        # [curves_done, curves_done+k) of the drawing stream, so each
        # frame computes and transfers only its new curves
        traj = simulate_paths(
            self.model, k, self.n_periods,
            self.initial_capital, self.seed, self.strategy,
            path_offset=self.curves_done, options=self.options,
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

        # spread the capped curve budget over the run; draw the remainder
        # on the final frame
        want = self.n_curves if final else min(
            self.n_curves, self.curves_done + self.curves_per_frame
        )
        self._add_curves(want - self.curves_done)

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
        if self.target is not None:
            self._axh.axhline(self.target, color="r", linewidth=1.0,
                              linestyle="--")
        self._axh.set_xlabel("paths")
        self._axh.set_title("final values (exact partial)")

        m = update.moments
        pct = 100.0 * update.done / max(update.n_paths, 1)
        title = (f"{update.done:,} / {update.n_paths:,} paths "
                 f"({pct:.1f}%)   mean {m.mean:,.1f}   std {m.std:,.1f}")
        if self.target is not None and m.count_below is not None:
            title += (f"   P(< {self.target:,.0f}) = "
                      f"{100.0 * m.count_below / max(update.done, 1):.3f}%")
        self._ax.set_title(title)
        self._fig.tight_layout()
        self._save()

    def _save(self) -> None:
        # atomic replace so a viewer never reads a half-written PNG
        d = os.path.dirname(os.path.abspath(self.out_path)) or "."
        fd, tmp = tempfile.mkstemp(suffix=".png", dir=d)
        os.close(fd)
        try:
            self._fig.savefig(tmp)
            os.replace(tmp, self.out_path)
        except BaseException:
            os.unlink(tmp)
            raise
        if self.frames_dir:
            # the frame is byte-identical to the PNG just written — copy
            # the file instead of paying a second full figure render
            # inside the engine's synchronous stream callback
            shutil.copyfile(
                self.out_path,
                os.path.join(self.frames_dir,
                             f"frame_{self.frames:04d}.png"),
            )
        self.frames += 1

    def close(self) -> None:
        if self._fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self._fig)
            self._fig = None


class FanoutStream:
    """Compose several stream consumers into one callback."""

    def __init__(self, *consumers):
        self.consumers = [c for c in consumers if c is not None]

    def __call__(self, update) -> None:
        for c in self.consumers:
            c(update)
