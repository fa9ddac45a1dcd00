"""The traced run's records: ``torch.profiler`` (CPU and CUDA activity)
over the window, exported as a Chrome trace and read back: the device's
operations, the host's torch operations and the window's own span.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

import numpy as np

from smmc_bench import metrics

WINDOW_SPAN = "smmc_bench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# gaps attributed to the host's operations: the longest ones
_GAPS_ATTRIBUTED = 500


@contextlib.contextmanager
def profiled(enabled: bool, device_type: str):
    """Yields the profiler (None when not ``enabled``) and the window's
    span context; the profiler starts before the window and stops after
    it."""
    if not enabled:
        yield None, contextlib.nullcontext
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof, lambda: record_function(WINDOW_SPAN)


def read(prof) -> dict:
    """(window, device_ops, host_ops) of a finished profile, from its
    Chrome trace (written under ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    window, device_ops, host_ops = None, [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            device_ops.append((name, cat, s, e))
        elif cat == "user_annotation" and name == WINDOW_SPAN:
            window = (s, e)
        elif cat == "cpu_op":
            host_ops.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    return dict(trace_window_us=window, device_ops=device_ops,
                host_ops=host_ops)


def breakdown(rec: metrics.Records) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps, each named by the innermost host torch operation running at its
    middle (the latest begun of those), summed by name (ten each, in
    seconds; the ``_GAPS_ATTRIBUTED`` longest gaps)."""
    lo, hi = rec.trace_window_us
    by_op = defaultdict(float)
    for name, _, s, e in rec.device_ops:
        if s >= lo and e <= hi:
            by_op[name] += (e - s) * 1e-6
    gaps = metrics.idle_gaps([(s, e) for _, _, s, e in rec.device_ops],
                             lo, hi)
    gaps.sort(key=lambda g: g[0] - g[1])
    by_host = defaultdict(float)
    if rec.host_ops:
        names = [n for n, _, _ in rec.host_ops]
        hs = np.array([s for _, s, _ in rec.host_ops])
        he = np.array([e for _, _, e in rec.host_ops])
    for gs, ge in gaps[:_GAPS_ATTRIBUTED]:
        label = "host: no torch operation"
        if rec.host_ops:
            mid = 0.5 * (gs + ge)
            running = np.flatnonzero((hs <= mid) & (he >= mid))
            if running.size:
                label = f"host: {names[running[np.argmax(hs[running])]]}"
        by_host[label] += (ge - gs) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:10]]
    return dict(device_ops=top(by_op), idle_gaps=top(by_host))
