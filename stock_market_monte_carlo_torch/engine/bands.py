"""Percentile bands over time without materializing (n_paths, T+1)
anywhere: each chunk's months are reduced on the device and only an
O(T * cells) table crosses to the host.

Counterpart of ``stock_market_monte_carlo_tpu/engine/bands.py`` on its
Pallas backend, with the same routing:

- ``band_mode="hist"``: per-month z-score histograms on a fixed
  [-12, 12] grid (month t's log-centre and log-scale from the log-growth
  moments), from the band-histogram kernel (``ops/bands.month_hist_chunk``);
- ``band_mode="cdf"``: per-month counts below K thresholds placed on the
  same z-grid, from the counts-below kernel (``month_cdf_chunk``),
  inverted on the host by probit interpolation;
- ``band_mode="analytic"``: the exact infinite-path marginals on the host
  (``ops/analytic.marginal_value_quantiles``), no sampling; counter and
  reference historical and Gaussian models;
- what the band kernels do not take (a fixed-amount strategy; Sobol and
  reference-parity models, in hist mode): the chunk's trajectories
  (``engine.sample_growth``/``compound_paths``) binned on the same grids,
  plain torch on the device (``_chunk_month_hist``), as the JAX package
  runs it as XLA; a fixed amount bins linearly on [0, hi_t].

The kernels emit months 1..T; month 0 (every path at v0) is added on the
host. Sample paths come from ``engine.simulate_paths``. The JAX package's
power-of-two bucketing of small runs (which saves Mosaic compiles and
changes no result) is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from stock_market_monte_carlo_torch.config import EngineOptions
from stock_market_monte_carlo_torch.engine import engine as eng
from stock_market_monte_carlo_torch.models.strategies import NoWithdrawal
from stock_market_monte_carlo_torch.ops import bands as kb
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_torch.ops import reductions as red
from stock_market_monte_carlo_torch.ops import threefry

Z_RANGE = 12.0


@dataclasses.dataclass
class TrajectoryBands:
    """Percentile bands over time + a capped set of sample trajectories."""

    quantile_levels: Tuple[float, ...]
    values: np.ndarray          # (len(levels), T+1) fund values
    months: np.ndarray          # (T+1,)
    sample_paths: np.ndarray    # (k, T+1)
    n_paths: int
    month_hist: np.ndarray      # (T+1, n_bins+2) accumulated counts; in
    # band_mode="cdf" this is the (T+1, K) counts-below table instead
    centers: np.ndarray         # (T+1,) log centers
    scales: np.ndarray          # (T+1,) log scales
    mode: str = "hist"
    log_thresholds: np.ndarray | None = None  # (T+1, K), cdf mode only

    def band(self, level: float) -> np.ndarray:
        return self.values[self.quantile_levels.index(level)]


def _expand(counts, valid, from_kernel: bool, idx0: int) -> np.ndarray:
    """One chunk's counts as a float64 (T+1, cells) block: the kernels
    emit months 1..T (month 0 is the v0 point mass, put in cell ``idx0``
    here); the linear route emits all T+1 rows."""
    c = np.asarray(counts, np.float64)
    if not from_kernel:
        return c
    out = np.zeros((c.shape[0] + 1, c.shape[1]), np.float64)
    out[0, idx0] = float(valid)
    out[1:] = c
    return out


def _chunk_month_hist(model, strategy, root_key, scramble_key, v0, offset,
                      valid, centers, inv_scales, b, t, n_bins, linear):
    """(T+1, n_bins+2) counts of one chunk's trajectories (``engine.
    sample_growth``); paths at or past ``valid`` are dropped. ``linear``
    (fixed amount): V/hi_t on [0, 1] into cells 1..n_bins+1, depleted
    paths (V <= 0) into cell 0. Otherwise the z-grid: z = (log V - c_t) *
    inv_scale_t, cell floor((z + 12) * n_bins / 24) + 1 clamped to [0,
    n_bins+1], depleted paths (log V <= log 1e-37) into cell 0."""
    growth = eng.sample_growth(model, root_key, scramble_key, offset, (b, t))
    traj = eng.compound_paths(growth, v0, strategy)[:valid]   # (valid, T+1)
    if linear:
        raw = torch.floor(traj * inv_scales[None, :] * float(n_bins))
        idx = torch.clamp(raw, 0.0, float(n_bins)).to(torch.int64) + 1
        idx = torch.where(traj <= 0.0, 0, idx)
    else:
        logv = torch.log(torch.clamp_min(traj, 1e-37))
        z = (logv - centers[None, :]) * inv_scales[None, :]
        raw = torch.floor((z + Z_RANGE) * ce._f32(n_bins / (2 * Z_RANGE)))
        idx = torch.clamp(raw, -1.0, float(n_bins)).to(torch.int64) + 1
        idx = torch.where(logv <= ce._f32(np.log(1e-37)), 0, idx)
    cells = n_bins + 2
    flat = idx + cells * torch.arange(t + 1, device=idx.device)[None, :]
    return torch.bincount(flat.reshape(-1), minlength=(t + 1) * cells
                          ).reshape(t + 1, cells)


def band_grid(model, strategy, n_periods: int, initial_capital: float):
    """(centers, scales) of the z-grid, (T+1,) each: month t's log centre
    log(v0) + t*mu_l and log scale sigma_l*sqrt(t); a percent strategy
    moves the centres by half the least log keep a month, so both tails
    stay inside +/-12 z. For a fixed-amount strategy, zero centres and the
    linear grid's tops hi_t (the +12-sigma envelope of the withdrawal-free
    fund: withdrawals only lower values)."""
    mu_l, sigma_l = eng.log_growth_moments(model)
    months = np.arange(n_periods + 1)
    centers = np.log(initial_capital) + months * mu_l
    if not eng._is_multiplicative(strategy):
        hi = np.exp(centers + Z_RANGE * sigma_l
                    * np.sqrt(np.maximum(months, 1)))
        return np.zeros_like(hi), hi
    if not isinstance(strategy, NoWithdrawal):
        centers = centers + months * np.log(max(
            1e-6,
            float(np.min(eng._keep_factors_np(strategy, max(n_periods, 1)))),
        )) * 0.5
    return centers, np.maximum(sigma_l * np.sqrt(np.maximum(months, 1)),
                               1e-9)


def hist_coefficients(centers, scales, n_bins: int, initial_capital: float):
    """(coef_a, coef_b, idx0) of the band-histogram kernel: float32 (T,)
    A_t, B_t of months 1..T, with cell floor(log V * A_t + B_t) + 1 the
    z-grid's cell of V, and month 0's cell of v0."""
    nb2z = n_bins / (2.0 * Z_RANGE)
    inv_s = 1.0 / scales
    coef_a = (inv_s[1:] * nb2z).astype(np.float32)
    coef_b = ((Z_RANGE - centers[1:] * inv_s[1:]) * nb2z).astype(np.float32)
    z0 = (np.log(initial_capital) - centers[0]) * inv_s[0]
    idx0 = int(np.clip(int(np.floor((z0 + Z_RANGE) * nb2z)) + 1, 0,
                       n_bins + 1))
    return coef_a, coef_b, idx0


def cdf_coefficients(centers, scales, n_thresholds: int,
                     initial_capital: float):
    """(coef_a, coef_b, kappa_lo, kappa_hi, logthr, m0row) of the
    counts-below kernel. Interior thresholds sit at uniform z in [-6, 6],
    the guard rows 0 and K-1 at -/+14 z as fractional k on the same
    affine-in-k log grid: log thr[t, k] = A_t + kk_k * B_t. ``coef_a``,
    ``coef_b``: float32 (T,) of months 1..T; ``logthr``: the (T+1, K) grid
    in the kernel's float32 arithmetic, for the inversion; ``m0row``:
    month 0's counts-below per path at v0."""
    z_int, z_guard = 6.0, 14.0
    dz = 2.0 * z_int / (n_thresholds - 3)
    z0 = -z_int - dz
    kap_lo = (-z_guard - z0) / dz
    kap_hi = (z_guard - z0) / dz
    kkv = np.arange(n_thresholds, dtype=np.float64)
    kkv[0], kkv[-1] = kap_lo, kap_hi
    cdf_a = (centers + z0 * scales).astype(np.float32)   # (T+1,)
    cdf_b = (dz * scales).astype(np.float32)
    logthr = (cdf_a[:, None]
              + kkv.astype(np.float32)[None, :] * cdf_b[:, None]
              ).astype(np.float64)
    m0row = (np.log(initial_capital) < logthr[0]).astype(np.float64)
    return cdf_a[1:], cdf_b[1:], kap_lo, kap_hi, logthr, m0row


def _linear_chunk_paths(n_periods: int, options: EngineOptions) -> int:
    """Paths per chunk of the linear route: the (B, T) growth buffer
    bounded to ~1 GiB of float32 (the JAX package's _xla_chunk_paths)."""
    b = (1 << 30) // (n_periods * 4 * 3)
    b = max(eng.KEY_TILE, (b // eng.KEY_TILE) * eng.KEY_TILE)
    return min(b, options.chunk_paths)


def simulate_bands(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    quantile_levels: Sequence[float] = (0.05, 0.25, 0.5, 0.75, 0.95),
    sample_paths: int = 32,
    n_bins: int = 1024,
    options: EngineOptions = EngineOptions(),
    progress=None,
    mesh=None,
    band_mode: str = "hist",
    n_thresholds: int = 32,
) -> TrajectoryBands:
    """Percentile bands over the full horizon for any number of paths,
    with O(T * n_bins) host transfer.

    ``band_mode="cdf"`` counts below ``n_thresholds`` thresholds per month
    instead of a histogram (the same sample, fewer cells) and inverts the
    quantiles by probit interpolation; ``month_hist`` is then the
    counts-below table and ``log_thresholds`` the threshold grid.
    ``band_mode="analytic"`` returns the exact infinite-path bands (month
    t's marginal is a t-fold convolution law, one FFT on the host);
    ``n_paths`` then only caps the sampled fan curves. ``progress(done,
    n_paths)`` is called after every absorbed chunk. Runs on
    ``options.device``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh runs are not ported yet (ROADMAP queue 1 item 13: "
            "multi-GPU over torch.distributed)"
        )
    eng._check_model(model)
    eng._validate_run(model, n_paths, options.chunk_paths, n_periods)
    months = np.arange(n_periods + 1)
    # fixed-amount withdrawals shift values additively, which a log-z grid
    # cannot bracket: they bin linearly on [0, hi_t]
    linear = not eng._is_multiplicative(strategy)
    centers, scales = band_grid(model, strategy, n_periods, initial_capital)
    use_kernels = not linear and kb.bands_supported(model, strategy.kind)
    if use_kernels:
        b = min(options.chunk_paths, 1 << 24)
        b = max(kb.TILE_PATHS, (b // kb.TILE_PATHS) * kb.TILE_PATHS)
    else:
        b = min(_linear_chunk_paths(n_periods, options), 1 << 24)
    if band_mode not in ("hist", "cdf", "analytic"):
        raise ValueError(f"band_mode must be 'hist', 'cdf', or "
                         f"'analytic', got {band_mode!r}")
    if options.terminal_law:
        raise ValueError(
            "terminal_law samples only the FINAL value's law; bands are "
            "month-resolved — use band_mode='analytic' for the exact "
            "infinite-path bands, or the default month-loop engine"
        )
    dev = eng._resolve_device(options)
    qs = tuple(quantile_levels)
    k = min(sample_paths, n_paths)

    def sample():
        return (eng.simulate_paths(model, k, n_periods, initial_capital,
                                   seed, strategy, options=options)
                if k > 0 else np.empty((0, n_periods + 1)))

    if band_mode == "analytic":
        from stock_market_monte_carlo_torch.ops import analytic as ana

        if linear:
            raise ValueError(
                "band_mode='analytic' needs a multiplicative strategy "
                "(fixed-amount withdrawals have no closed marginal law)"
            )
        if model.kind not in ("gaussian", "historical"):
            raise ValueError(
                "band_mode='analytic' supports gaussian/historical "
                f"models (the marginal law is closed-form); got "
                f"{model.kind!r}"
            )
        if model.kind == "gaussian":
            kind, params = "gaussian", (float(model.mean_pct),
                                        float(model.std_pct))
        else:
            kind, params = "bootstrap", np.asarray(model.returns_pct,
                                                   np.float64)
        keep = (None if isinstance(strategy, NoWithdrawal)
                else eng._keep_factors_np(strategy, n_periods).astype(
                    np.float64))
        values = ana.marginal_value_quantiles(
            kind, params, n_periods, float(initial_capital), qs, keep=keep)
        return TrajectoryBands(
            quantile_levels=qs, values=values, months=months,
            sample_paths=sample(),
            n_paths=0,      # exact law, not an n-path estimate
            month_hist=np.zeros((n_periods + 1, 0)), centers=centers,
            scales=scales, mode="analytic",
        )

    use_cdf = band_mode == "cdf"
    if use_kernels:
        keep_np = (None if isinstance(strategy, NoWithdrawal)
                   else eng._keep_factors_np(strategy, n_periods))
    if use_cdf:
        if linear:
            raise ValueError(
                "band_mode='cdf' needs a multiplicative strategy (the "
                "log-space threshold grid cannot bracket fixed-amount "
                "withdrawals) — use band_mode='hist'"
            )
        if not use_kernels:
            raise ValueError(
                "band_mode='cdf' runs on the fused Pallas band kernels "
                "only: set EngineOptions(backend='pallas') and use a "
                "gaussian/historical counter-rng model"
            )
        if not kb.cdf_supported(model, strategy.kind, n_periods,
                                n_thresholds):
            raise ValueError(
                f"band_mode='cdf' unsupported for n_periods={n_periods}, "
                f"n_thresholds={n_thresholds}: K must be a multiple of 8 "
                f">= 8 and the (T*K, 128) int32 accumulator must fit the "
                f"VMEM budget (T*K <= {kb._CDF_VMEM_CAP // 512})"
            )
        coef_a, coef_b, kap_lo, kap_hi, logthr, m0row = cdf_coefficients(
            centers, scales, n_thresholds, initial_capital)
        # the kernel checks the order of the thresholds on the host copy
        reduce_kw = dict(kappa_lo=kap_lo, kappa_hi=kap_hi,
                         n_thresholds=n_thresholds, coef_b_host=coef_b)
        chunk_fn = kb.month_cdf_chunk
        total = np.zeros((n_periods + 1, n_thresholds), np.float64)

        def absorb(counts, valid):
            out = np.zeros_like(total)
            out[0] = float(valid) * m0row
            out[1:] = counts.numpy()
            return out
    else:
        if use_kernels:
            coef_a, coef_b, idx0 = hist_coefficients(
                centers, scales, n_bins, initial_capital)
            # the kernel checks A_t > 0 on the host copy; the cell edges
            # are computed once for every chunk
            reduce_kw = dict(n_bins=n_bins, coef_a_host=coef_a)
            chunk_fn = kb.month_hist_chunk
        total = np.zeros((n_periods + 1, n_bins + 2), np.float64)

        def absorb(counts, valid):
            return _expand(counts.numpy(), valid, use_kernels,
                           idx0 if use_kernels else 0)

    if use_kernels:
        table, draw = ce.draw_operands(model, dev)
        keep_t = (None if keep_np is None
                  else torch.as_tensor(keep_np, device=dev))
        coef_a_t = torch.as_tensor(coef_a, device=dev)
        coef_b_t = torch.as_tensor(coef_b, device=dev)
        if not use_cdf and dev.type == "cuda":
            reduce_kw["edges"] = kb.hist_edges(coef_a_t, coef_b_t, n_bins)
        base = eng._segment_base(seed, 0)

        def run_chunk(offset, valid, this_b):
            return chunk_fn(table, keep_t, coef_a_t, coef_b_t,
                            n_periods=n_periods, seed_base=base,
                            tile0=offset // kb.TILE_PATHS, valid=valid,
                            n_paths=this_b, v0=initial_capital, **draw,
                            **reduce_kw)
    else:
        root_key = threefry.key(seed, dev)
        scramble_key = eng._scramble_key(seed, dev)
        centers_t = torch.as_tensor(centers.astype(np.float32), device=dev)
        inv_scales = torch.as_tensor((1.0 / scales).astype(np.float32),
                                     device=dev)

        def run_chunk(offset, valid, this_b):
            return _chunk_month_hist(model, strategy, root_key, scramble_key,
                                     initial_capital, offset, valid,
                                     centers_t, inv_scales, this_b,
                                     n_periods, n_bins, linear)

    def absorb_pending():
        (counts, copied), valid = pending
        if copied is not None:
            copied.synchronize()
        return absorb(counts, valid), valid

    done, offset, remaining = 0, 0, n_paths
    # (host counts, their copy's event or None, valid): absorbed after the
    # next chunk's launch, so the card runs it meanwhile
    pending = None
    while remaining > 0:
        valid = min(remaining, b)
        this_b = b if n_paths > b else eng._round_up(valid, eng.KEY_TILE)
        counts = eng.pinned_copy(run_chunk(offset, valid, this_b))
        if pending is not None:
            block, n = absorb_pending()
            total += block
            done += n
            if progress is not None:
                progress(done, n_paths)
        pending = (counts, valid)
        offset += this_b
        remaining -= valid
    block, n = absorb_pending()
    total += block
    done += n
    if progress is not None:
        progress(done, n_paths)

    # invert to fund values per quantile per month (host, O(T))
    values = np.empty((len(qs), n_periods + 1))
    if use_cdf:
        # probit-space interpolation of the K-point per-month CDF; ranks
        # below the underflow-guard threshold (depleted mass) -> 0.0
        values[:, 0] = initial_capital  # month 0 is exactly v0
        for tt in range(1, n_periods + 1):
            lq = red.cdf_band_quantiles(total[tt], logthr[tt], qs, n_paths)
            v = np.exp(lq)
            v[~np.isfinite(lq)] = 0.0
            values[:, tt] = v
        return TrajectoryBands(
            quantile_levels=qs, values=values, months=months,
            sample_paths=sample(), n_paths=n_paths, month_hist=total,
            centers=centers, scales=scales, mode="cdf",
            log_thresholds=logthr,
        )
    if linear:
        z_edges = np.linspace(0.0, 1.0, n_bins + 1)
    else:
        z_edges = np.linspace(-Z_RANGE, Z_RANGE, n_bins + 1)
    pad = z_edges[1] - z_edges[0]
    full_edges = np.concatenate(
        [[z_edges[0] - pad], z_edges, [z_edges[-1] + pad]])
    for tt in range(n_periods + 1):
        zq = red.grid_quantiles(total[tt], full_edges, qs)
        depleted = zq < z_edges[0]   # rank fell in the underflow bin
        if linear:
            v = zq * scales[tt]
        else:
            v = np.exp(centers[tt] + zq * scales[tt])
        v[depleted] = 0.0
        values[:, tt] = v
    return TrajectoryBands(
        quantile_levels=qs, values=values, months=months,
        sample_paths=sample(), n_paths=n_paths, month_hist=total,
        centers=centers, scales=scales,
    )
