"""Host-side statistics: the packed moment layout, moment summaries and
histogram queries (numpy, float64).

The host parts of ``stock_market_monte_carlo_tpu.ops.reductions``. A chunk
reduces on the device to one packed row (n, power sums of V/v0 about a
shift, min, max, count below the target, withdrawn) and a fixed log-spaced
histogram; the host merges rows exactly in float64 and derives the moments
and quantiles here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Order of scalar moment fields in the packed stats vector.
STAT_FIELDS = (
    "n", "sum", "sum_sq", "sum_cube", "sum_quart",
    "min", "max", "count_below", "sum_withdrawn",
)
N_STATS = len(STAT_FIELDS)


def zero_packed_stats():
    z = np.zeros(N_STATS, np.float64)
    z[5] = np.inf
    z[6] = -np.inf
    return z


@dataclasses.dataclass
class MomentSummary:
    """Derived statistics from power sums (host-side, float64)."""

    n: int
    mean: float
    var: float
    std: float
    min: float
    max: float
    skew: float
    kurtosis: float
    count_below: Optional[int]
    total_withdrawn: float

    @classmethod
    def from_packed(cls, s: np.ndarray,
                    target_enabled: bool) -> "MomentSummary":
        n = float(s[0])
        mean = s[1] / n
        m2 = s[2] / n - mean**2
        var = max(m2, 0.0)
        std = float(np.sqrt(var))
        m3 = s[3] / n - 3 * mean * s[2] / n + 2 * mean**3
        m4 = (s[4] / n - 4 * mean * s[3] / n + 6 * mean**2 * s[2] / n
              - 3 * mean**4)
        skew = float(m3 / std**3) if std > 0 else 0.0
        kurt = float(m4 / var**2) if var > 0 else 0.0
        return cls(
            n=int(round(n)),
            mean=float(mean),
            var=float(var),
            std=std,
            min=float(s[5]),
            max=float(s[6]),
            skew=skew,
            kurtosis=kurt,
            count_below=int(round(float(s[7]))) if target_enabled else None,
            total_withdrawn=float(s[8]),
        )


@dataclasses.dataclass(frozen=True)
class HistogramSpec:
    """Fixed log-spaced binning with underflow/overflow bins.

    Bin 0 counts values below lo (including depleted funds); bin
    ``n_bins+1`` counts values at or above hi. Interior bin b (1-based)
    covers [exp(log_lo + (b-1)*w), exp(log_lo + b*w)).
    """

    lo: float
    hi: float
    n_bins: int

    @property
    def log_lo(self):
        return float(np.log(self.lo))

    @property
    def log_hi(self):
        return float(np.log(self.hi))

    @property
    def width(self):
        return (self.log_hi - self.log_lo) / self.n_bins


def prob_below_from_histogram(spec: HistogramSpec, counts: np.ndarray,
                              amount: float) -> float:
    """P(value < amount) from histogram counts: exact at bin edges,
    log-linear inside a bin; the open-ended bins are attributed whole."""
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if amount <= 0 or total == 0:
        return 0.0
    loga = np.log(amount)
    if loga <= spec.log_lo:
        return float(counts[0] / total)
    if loga >= spec.log_hi:
        return 1.0
    pos = (loga - spec.log_lo) / spec.width
    b = int(np.floor(pos))
    b = min(b, spec.n_bins - 1)
    frac = pos - b
    below = counts[0] + counts[1:1 + b].sum() + frac * counts[1 + b]
    return float(below / total)


def grid_quantiles(counts: np.ndarray, grid_edges: np.ndarray,
                   qs) -> np.ndarray:
    """Histogram quantiles on a monotone grid of n_bins+3 edges (pseudo-
    edges bracket the open-ended bins); linear inside a bin in grid
    space."""
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    cdf = np.cumsum(counts)
    n_last = len(counts) - 1
    out = []
    for q in np.atleast_1d(qs):
        rank = q * total
        b = int(np.searchsorted(cdf, rank, side="left"))
        b = min(b, n_last)
        prev = cdf[b - 1] if b > 0 else 0.0
        inbin = counts[b]
        frac = (rank - prev) / inbin if inbin > 0 else 0.5
        out.append(grid_edges[b] + frac * (grid_edges[b + 1]
                                           - grid_edges[b]))
    return np.asarray(out)


def quantiles_from_histogram(spec: HistogramSpec, counts: np.ndarray,
                             qs) -> np.ndarray:
    """Quantiles with intra-bin linear interpolation in log space (error
    bounded by one log-space bin width)."""
    log_edges = np.concatenate([
        [spec.log_lo - 1.0],  # pseudo-edge for the underflow bin
        np.linspace(spec.log_lo, spec.log_hi, spec.n_bins + 1),
        [spec.log_hi + 1.0],
    ])
    return np.exp(grid_quantiles(counts, log_edges, qs))


def norm_icdf64(p):
    """Float64 standard-normal quantile (Acklam's rational approximation,
    ~1.15e-9 relative error)."""
    p = np.asarray(p, np.float64)
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p = np.clip(p, 1e-300, 1.0 - 1e-16)
    out = np.empty_like(p)
    lo = p < 0.02425
    hi = p > 1.0 - 0.02425
    mid = ~(lo | hi)

    def tail(pp):
        q = np.sqrt(-2.0 * np.log(pp))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) \
            * q + c[5]
        den = (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
        return num / den

    out[lo] = tail(p[lo])
    out[hi] = -tail(1.0 - p[hi])
    q = p[mid] - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) \
        * r + a[5]
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) \
        * r + 1.0
    out[mid] = q * num / den
    return out


def cdf_band_quantiles(counts_below: np.ndarray,
                       log_thresholds: np.ndarray, qs,
                       n_valid: int) -> np.ndarray:
    """Quantiles (in log-value space) from counts below K monotone
    thresholds: the host inversion of the bands CDF mode.

    Interpolation runs in probit space: with F_k the empirical CDF at
    threshold k, the crossing of level q between thresholds j-1 and j is
    placed at the z-fraction (z(q) - z(F_{j-1})) / (z(F_j) - z(F_{j-1})),
    exact where the sample is lognormal between the two thresholds.
    Returns -inf for quantiles whose rank falls below the first
    (underflow-guard) threshold, the depleted mass, which the caller maps
    to fund value 0.0; quantiles past the last threshold clamp to it.
    """
    F = np.asarray(counts_below, np.float64) / float(n_valid)
    L = np.asarray(log_thresholds, np.float64)
    eps = 0.5 / float(max(n_valid, 1))
    z = norm_icdf64(np.clip(F, eps, 1.0 - eps))
    out = []
    for q in np.atleast_1d(qs):
        j = int(np.searchsorted(F, q, side="left"))  # first F_j >= q
        if j == 0:
            out.append(-np.inf)
            continue
        if j >= len(F):
            out.append(L[-1])
            continue
        za, zb = z[j - 1], z[j]
        if zb <= za:  # flat segment (both clipped / zero mass between)
            w = 0.5
        else:
            zq = float(norm_icdf64(np.clip(q, eps, 1.0 - eps)))
            w = float(np.clip((zq - za) / (zb - za), 0.0, 1.0))
        out.append(L[j - 1] + w * (L[j] - L[j - 1]))
    return np.asarray(out)


def default_histogram_spec(initial_capital: float, n_periods: int,
                           log_growth_mean: float, log_growth_std: float,
                           n_bins: int) -> HistogramSpec:
    """Analytic bin range: +/-12 sigma of the log final value (a sum of
    n_periods i.i.d. log growth factors) around its mean."""
    t = float(n_periods)
    center = np.log(initial_capital) + t * log_growth_mean
    half = 12.0 * np.sqrt(t) * log_growth_std + 1e-6
    return HistogramSpec(
        lo=float(np.exp(center - half)),
        hi=float(np.exp(center + half)),
        n_bins=n_bins,
    )
