"""The arithmetic that turns a run's records into metrics: the rate, the
tail, the union of device intervals, and what one query needs at the
least.

``Records`` is what the metric readers (``end_to_end/<name>.py`` and
``layer_metrics/<name>.py``) read: each has ``read(rec) -> float | None``
and returns None where the run holds nothing for it to read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet and Hopper white paper: HBM3 bandwidth, dense
# bf16 tensor-core rate, and 32-bit scalar issue (132 SMs x 128 lanes x
# 1.98 GHz: the 67 TFLOP/s float32 with an FMA counted as one operation)
HBM_BYTES_PER_S = 3.35e12
TENSOR_BF16_FLOP_PER_S = 989e12
SCALAR_OPS_PER_S = 132 * 128 * 1.98e9


@dataclasses.dataclass
class Records:
    """What one run recorded. Host times are seconds of the host clock;
    the trace's (``device_ops``, ``host_ops``, the window) are
    microseconds of the profiler's clock, and only a traced run has
    them."""

    setup_s: float
    window_s: float
    walls_s: List[float]
    paths_per_query: int
    least_s_per_query: float
    trace_window_us: Optional[Tuple[float, float]] = None
    # (name, category, start, end): kernels, copies and memsets
    device_ops: List[tuple] = dataclasses.field(default_factory=list)
    # (name, start, end): the host's torch operations
    host_ops: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def n_queries(self) -> int:
        return len(self.walls_s)

    @property
    def traced(self) -> bool:
        return self.trace_window_us is not None


def quantile(values, q: float) -> float:
    """The q-quantile of ``values``, linear between order statistics."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo,
    hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) gaps of [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def device_window(rec: Records):
    """(window, busy) seconds of a traced run: the traced window's length
    and the union of its device operations."""
    lo, hi = rec.trace_window_us
    busy = union_us([(s, e) for _, _, s, e in rec.device_ops], lo, hi)
    return (hi - lo) * 1e-6, busy * 1e-6


def least_seconds(work: dict) -> float:
    """The least time of some work on one H100: the larger of its bytes
    at the HBM rate and its operations at their peak rates."""
    return max(work["bytes"] / HBM_BYTES_PER_S,
               work["scalar_ops"] / SCALAR_OPS_PER_S,
               work["tensor_flop"] / TENSOR_BF16_FLOP_PER_S)
