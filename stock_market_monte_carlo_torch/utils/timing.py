"""Tracing: the program's spans and a profiler wrapper.

- ``span(name)``: a named range of the program. While a ``torch.profiler``
  records, it is ``torch.profiler.record_function(name)``, so the range
  lands in the profiler's trace as a ``user_annotation`` event on the
  host clock the device's activity is aligned to. While none records it
  is a shared no-op context: one flag check, no clock read, no
  allocation.
- ``spanned(name)``: a decorator that runs the whole call as
  ``span(name)``.
- ``trace``: a ``torch.profiler`` context writing a Chrome/Perfetto trace
  of the host and, on a card, its kernels; the spans are in it.

The spans of the two entry points (``engine.simulate_stats``,
``bands.simulate_bands``), each nested in its entry span:

- ``smmc.simulate_stats``, ``smmc.simulate_bands``: the whole call;
- ``smmc.prepare``: from the entry to the first chunk (histogram spec,
  chunk function, band grid, coefficients, draw operands, the edges'
  bisection);
- ``smmc.dispatch``: the host's enqueue of one chunk through its chunk
  wrapper (the bands' pinned copy's enqueue included; a stats run that
  merges every chunk queues its copies after the previous chunk's merge,
  outside the span);
- ``smmc.wait``: the host blocked on the card for a chunk's results;
- ``smmc.merge``: the host's float64 merge of fetched results;
- ``smmc.invert``: the bands' quantile inversion, one pass over the
  month table;
- ``smmc.sample_paths``: the bands' sample paths;
- ``smmc.law_operand``: a terminal-law run's operand, inside
  ``smmc.prepare`` (the fit cache's lookup, the host-to-device copy);
- ``smmc.law_fit``: inside ``smmc.law_operand`` on a fit cache miss only
  (the FFT oracle, the fit, its validation).
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

# one shared no-op context: a span costs no allocation while no profiler
# records
_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """The context of a program span named ``name``: a profiler range
    while a profiler records, else a no-op."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function is one ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


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
