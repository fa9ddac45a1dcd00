"""GUI-toolkit demo window — the `example_imgui` counterpart (the port's
copy of ``stock_market_monte_carlo_tpu/viz/demo.py``; its runs go through
the port's engine on ``EngineOptions.device``).

The reference ships a stock toolkit showcase: ImGui's demo window plus
a small custom panel (checkbox, slider, button, counter, FPS readout)
rendered in a GLFW loop (examples/example_imgui.cpp:
176-247). This is the same form for the matplotlib-widget toolkit the
framework's real GUI (viz/gui.InteractiveWindow) is built on: one
window exercising every widget kind the production window uses —
Slider, Button, CheckButtons, RadioButtons — wired to a tiny live
simulation so the widgets demonstrably drive recomputation.

Like the production window it is headless-testable: on Agg nothing
blocks, and each widget's programmatic event entry point
(``slider.set_val`` / ``button-click via _clicked`` / checkbox
``set_active``) fires the same callbacks the mouse would.
"""

from __future__ import annotations

import numpy as np


class DemoWindow:
    """Widget showcase over a live mini-simulation."""

    N_PATHS = 8192

    def __init__(self, seed: int = 0, options=None):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import (
            Button,
            CheckButtons,
            RadioButtons,
            Slider,
        )

        from stock_market_monte_carlo_torch.config import EngineOptions

        self._plt = plt
        self.options = options if options is not None else EngineOptions()
        self.seed = seed
        self.model_kind = "gaussian"
        self.show_hist = True
        self.clicks = 0

        self.fig = plt.figure(figsize=(12, 7))
        gs = self.fig.add_gridspec(
            3, 3, width_ratios=[4, 1.2, 1.2], height_ratios=[10, 1, 1],
            hspace=0.45, wspace=0.3,
        )
        self.ax = self.fig.add_subplot(gs[0, 0])
        self._ax_radio = self.fig.add_subplot(gs[0, 1])
        self._ax_check = self.fig.add_subplot(gs[0, 2])
        self._ax_slider = self.fig.add_subplot(gs[1, :])
        self._ax_button = self.fig.add_subplot(gs[2, 0])
        self.status = self.fig.text(0.55, 0.08, "", fontsize=10,
                                    family="monospace")

        self.slider = Slider(self._ax_slider, "months", 6, 240,
                             valinit=60, valstep=6)
        self.slider.on_changed(self._on_change)
        self.button = Button(self._ax_button, "re-seed + rerun")
        self.button.on_clicked(self._on_click)
        self.radio = RadioButtons(self._ax_radio,
                                  ("gaussian", "historical"))
        self.radio.on_clicked(self._on_model)
        self.check = CheckButtons(self._ax_check, ["histogram"], [True])
        self.check.on_clicked(self._on_check)
        self._rerun()

    # --- widget callbacks (mouse or programmatic, same entry) ----------

    def _on_change(self, _val):
        self._rerun()

    def _on_click(self, _event):
        self.clicks += 1
        self.seed += 1
        self._rerun()

    def _on_model(self, label):
        self.model_kind = label
        self._rerun()

    def _on_check(self, _label):
        self.show_hist = not self.show_hist
        self._rerun()

    # -------------------------------------------------------------------

    def _rerun(self):
        import stock_market_monte_carlo_torch as smmc

        t = int(self.slider.val)
        model = (smmc.GaussianReturns()
                 if self.model_kind == "gaussian"
                 else smmc.HistoricalBootstrap.from_csv())
        self.result = smmc.simulate_stats(model, self.N_PATHS, t,
                                          seed=self.seed,
                                          options=self.options)
        self.ax.cla()
        if self.show_hist and self.result.histogram_counts is not None:
            from stock_market_monte_carlo_torch.viz.live import (
                downsample_histogram,
                trim_histogram,
            )

            counts, edges = trim_histogram(self.result.histogram_counts,
                                           self.result.histogram_spec)
            if counts is not None:
                cd, ed = downsample_histogram(counts, edges)
                self.ax.bar(0.5 * (ed[:-1] + ed[1:]), cd,
                            width=np.diff(ed))
            self.ax.set_xlabel("final value")
        self.ax.set_title(
            f"{self.model_kind} {self.N_PATHS} x {t}mo   "
            f"mean {self.result.mean:,.1f}  std {self.result.std:,.1f}"
        )
        self.status.set_text(
            f"seed {self.seed}  clicks {self.clicks}  "
            f"hist {'on' if self.show_hist else 'off'}"
        )
        self.fig.canvas.draw_idle()

    def show(self):
        import matplotlib

        if matplotlib.get_backend().lower() not in (
                "agg", "pdf", "svg", "ps", "template"):
            self._plt.show()

    def close(self):
        self._plt.close(self.fig)


def demo_gui(options=None):
    win = DemoWindow(options=options)
    win.show()
    return win
