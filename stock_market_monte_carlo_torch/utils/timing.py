"""Tracing and phase timing.

Counterpart of ``stock_market_monte_carlo_tpu/utils/timing.py``:

- ``PhaseTimer``: named wall-clock phases that wait for the device at
  their boundary (``torch.cuda.synchronize`` and a scalar fetch from the
  tensors the phase produced), so a phase's time is the device's, not the
  launches'. Prints a per-phase table like the reference's timer blocks.
- ``trace``: a ``torch.profiler`` context writing a Chrome/Perfetto trace
  of the host and, on a card, its kernels.
- ``time_fn``: best-of-reps wall time of a callable, completion forced.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import torch


class PhaseTimer:
    """Accumulating named phase timer with device-sync boundaries.

    Usage::

        pt = PhaseTimer()
        with pt.phase("simulate", out):   # out: tensors the phase produced
            ...
        print(pt.report())
    """

    def __init__(self):
        self.phases: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str, *sync_tensors):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _force(sync_tensors)
            self.phases.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.phases:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        totals = self.totals()
        width = max((len(n) for n in totals), default=5)
        lines = [f"{'phase':<{width}s}    seconds"]
        total = 0.0
        for name, dt in totals.items():
            lines.append(f"{name:<{width}s}  {dt:9.4f}")
            total += dt
        lines.append(f"{'TOTAL':<{width}s}  {total:9.4f}")
        return "\n".join(lines)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for item in x:
            yield from _leaves(item)
    elif isinstance(x, dict):
        for item in x.values():
            yield from _leaves(item)


def _force(objs) -> None:
    """Wait until every tensor in ``objs`` (nested lists, tuples and dicts
    of them; anything else is ignored) is computed: synchronize its card,
    then fetch one element of the first tensor."""
    tensors = [t for o in objs if o is not None for t in _leaves(o)]
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    first = next((t for t in tensors if t.numel()), None)
    if first is not None:
        first.reshape(-1)[0].item()


@contextlib.contextmanager
def trace(log_dir: str = "smmc_trace"):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write ``trace.json`` (Chrome/Perfetto) into
    ``log_dir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn, *args, warmup: int = 1, reps: int = 3,
            label: Optional[str] = None) -> float:
    """Best-of-reps wall time of ``fn(*args)`` with forced completion.
    Returns seconds; prints when ``label`` is given."""
    for _ in range(warmup):
        _force([fn(*args)])
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _force([fn(*args)])
        best = min(best, time.perf_counter() - t0)
    if label:
        print(f"{label}: {best * 1e3:.2f} ms")
    return best
