"""Progress reporting for long runs.

Counterpart of ``stock_market_monte_carlo_tpu/engine/progress.py``: the
engine calls ``progress(done, total)`` after every absorbed chunk, and
``TerminalProgress`` renders it as a live terminal line.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

# signature: (paths_done, paths_total) -> None
ProgressCallback = Callable[[int, int], None]


class TerminalProgress:
    """Live single-line progress: count, percent, rate, ETA."""

    def __init__(self, stream=None, min_interval_s: float = 0.1):
        self.stream = stream or sys.stderr
        self.min_interval_s = min_interval_s
        self._start: Optional[float] = None
        self._last_print = 0.0
        # set on the first callback, where a checkpoint resume reports the
        # earlier run's paths
        self._done0 = 0

    def __call__(self, done: int, total: int) -> None:
        now = time.monotonic()
        if self._start is None:
            self._start = now
            # rate and ETA count only the paths of this run
            self._done0 = done
        if done < total and now - self._last_print < self.min_interval_s:
            return
        self._last_print = now
        elapsed = now - self._start
        rate = (done - self._done0) / elapsed if elapsed > 0 else 0.0
        eta = (total - done) / rate if rate > 0 else float("inf")
        pct = 100.0 * done / total if total else 100.0
        msg = (
            f"\r{done}/{total} simulations done ({pct:5.1f}%) | "
            f"{rate:,.0f} paths/s | eta {eta:6.1f}s"
        )
        self.stream.write(msg)
        if done >= total:
            self.stream.write("\n")
        self.stream.flush()
