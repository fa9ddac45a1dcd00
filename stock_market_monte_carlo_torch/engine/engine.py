"""The simulation engine: a host chunk loop over the device chunk functions.

Counterpart of ``stock_market_monte_carlo_tpu/engine/engine.py`` on its
Pallas backend, for the slice the port covers: ``simulate_stats``,
``simulate_final_values``, ``simulate`` and ``run`` on
``HistoricalBootstrap`` and ``GaussianReturns`` models. The sampler is
chosen as the JAX package chooses it on its Pallas backend
(``_effective_sampler``): the month loop with the historical or the
Gaussian ICDF draw, the CLT kernel (``EngineOptions.gaussian_sampler``
"clt" / "clt-prefix"), or, with ``terminal_law=True``, the terminal law.

A run streams in chunks of ``chunk_paths`` paths. Each chunk reduces on
the device to one float32 stats row and a histogram
(``ops/cuda_engine.py``); the host merges the rows in float64, in chunk
order (``_absorb``). When nothing consumes per-chunk results (no progress
or stream callback, no finals), every chunk is launched before the first
host sync, in batches of at most ``_DEFER_FLUSH_CHUNKS``.

Out of this slice, and raising ``NotImplementedError`` with the ROADMAP
item that ports them: checkpoints, meshes, runs past one seed segment,
trajectories, Sobol models, the reference-parity stream, trajectory bands
and RQMC.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from stock_market_monte_carlo_torch.config import EngineOptions
from stock_market_monte_carlo_torch.engine.results import SimulationResult
from stock_market_monte_carlo_torch.models.market import GaussianReturns
from stock_market_monte_carlo_torch.models.strategies import (
    FixedPercentWithdrawal,
    NoWithdrawal,
    VariablePercentWithdrawal,
)
from stock_market_monte_carlo_torch.ops import clt
from stock_market_monte_carlo_torch.ops import cuda_engine
from stock_market_monte_carlo_torch.ops import reductions as red

KEY_TILE = cuda_engine.TILE_PATHS

# deferred-absorb queue bound: flush (one stacked fetch + f64 merges)
# every N chunks so device memory stays O(N), not O(n_chunks)
_DEFER_FLUSH_CHUNKS = 256

# ---------------------------------------------------------------------------
# Host-side analytics.
# ---------------------------------------------------------------------------

_GAUSS_LGM_CACHE: dict = {}


def log_growth_moments(model) -> Tuple[float, float]:
    """(mean, std) of log((100+r)/100) under the model: 201-node
    Gauss-Hermite quadrature for Gaussian models (cached per (mean, std)),
    the exact discrete moments of the table for bootstrap models."""
    if isinstance(model, GaussianReturns):
        mean = float(np.asarray(model.mean_pct))
        std = float(np.asarray(model.std_pct))
        hit = _GAUSS_LGM_CACHE.get((mean, std))
        if hit is not None:
            return hit
        z, w = np.polynomial.hermite_e.hermegauss(201)
        g = mean + std * z
        g = np.clip(g, -99.99, None)
        f = np.log((100.0 + g) / 100.0)
        w = w / w.sum()
        mu = float(np.sum(w * f))
        var = float(np.sum(w * f * f) - mu * mu)
        out = (mu, float(np.sqrt(max(var, 1e-30))))
        if len(_GAUSS_LGM_CACHE) > 256:  # unbounded-growth guard
            _GAUSS_LGM_CACHE.clear()
        _GAUSS_LGM_CACHE[(mean, std)] = out
        return out
    table = np.asarray(model.returns_pct, np.float64)
    f = np.log((100.0 + np.clip(table, -99.99, None)) / 100.0)
    mu = float(f.mean())
    var = float(f.var())
    return mu, float(np.sqrt(max(var, 1e-30)))


def analytic_moment_shift(model, strategy, n_periods: int) -> float:
    """E[V_T]/v0 for multiplicative strategies (0 otherwise): the centre
    of the device power sums, which keeps the float32 variance extraction
    well-conditioned. ``_absorb`` restores the raw sums in float64."""
    if not _is_multiplicative(strategy):
        return 0.0
    if isinstance(model, GaussianReturns):
        g = 1.0 + float(np.asarray(model.mean_pct)) / 100.0
    else:
        table = np.asarray(model.returns_pct, np.float64)
        g = float(1.0 + table.mean() / 100.0)
    keep = _keep_factors_np(strategy, n_periods).astype(np.float64)
    with np.errstate(over="ignore", under="ignore"):
        c = float(g ** n_periods * np.prod(keep))
    if not np.isfinite(c):
        return 0.0
    return float(np.clip(c, 0.0, 1e30))


def make_histogram_spec(model, strategy, n_periods: int,
                        initial_capital: float,
                        n_bins: int) -> red.HistogramSpec:
    mu, sigma = log_growth_moments(model)
    if isinstance(strategy, (FixedPercentWithdrawal,
                             VariablePercentWithdrawal)):
        # shift the log-centre by the mean per-month log-keep, clamped so
        # a 100% withdrawal (keep 0) still gives a valid log-spaced spec
        if isinstance(strategy, FixedPercentWithdrawal):
            pct = np.float64(np.asarray(strategy.percent))
        else:
            pct = np.asarray(strategy.percent_schedule,
                             np.float64)[:n_periods]
        keep = np.clip(1.0 - pct / 100.0, 1e-6, None)
        mu += float(np.mean(np.log(keep)))
    spec = red.default_histogram_spec(
        initial_capital, n_periods, mu, sigma, n_bins
    )
    if not isinstance(strategy, NoWithdrawal):
        # withdrawals drive funds toward zero: widen the low end, with lo
        # floored into float32 range so exact zeros reach the underflow bin
        lo = max(min(spec.lo, initial_capital * 1e-6 + 1e-30), 1e-30)
        hi = max(spec.hi, lo * 1e6)
        spec = red.HistogramSpec(lo=lo, hi=hi, n_bins=n_bins)
    return spec


def _is_multiplicative(strategy) -> bool:
    return strategy.kind in ("none", "fixed_percent", "variable_percent")


def _keep_factors_np(strategy, n_periods: int) -> np.ndarray:
    """(T,) float32 keep fraction per month of a multiplicative strategy:
    computed once on the host, the single source the kernels and the host
    analytics share."""
    if isinstance(strategy, NoWithdrawal):
        return np.ones((n_periods,), np.float32)
    if isinstance(strategy, FixedPercentWithdrawal):
        keep = np.float32(1.0) - np.float32(strategy.percent) / np.float32(
            100.0)
        return np.full((n_periods,), keep, np.float32)
    sched = np.asarray(strategy.percent_schedule, np.float32)
    if sched.shape[0] < n_periods:
        raise ValueError(
            f"percent_schedule has {sched.shape[0]} entries but the run "
            f"has n_periods={n_periods}; provide a schedule covering "
            "every period"
        )
    return (np.float32(1.0) - sched[:n_periods] / np.float32(100.0))


def _validate_terminal_law(strategy, options) -> None:
    """Structural preconditions of EngineOptions(terminal_law=True) (the
    model kinds are checked by ``_check_slice``); the fit itself validates
    smoothness and keep > 0."""
    if not _is_multiplicative(strategy):
        raise ValueError(
            "terminal_law=True needs a multiplicative strategy (the "
            "fixed-amount withdrawal makes V_T path-dependent beyond "
            "the terminal law); use the month-loop engine"
        )
    if strategy.kind != "none" and options.track_withdrawn:
        raise ValueError(
            "terminal_law cannot track per-path withdrawn totals "
            "(they are path-dependent; only V_T's law is sampled) — "
            "set EngineOptions(track_withdrawn=False) to run the "
            "strategy's finals at terminal-law speed"
        )


def _effective_sampler(model, strategy, options: EngineOptions) -> str:
    """The sampler that runs (``engine._effective_sampler`` of the JAX
    package on its Pallas backend, which the port always is):

    - ``"law"``: ``terminal_law=True``;
    - ``"icdf"``: the month loop; historical models (whatever
      ``gaussian_sampler`` says), Gaussian models by default, and the cases
      below that the CLT kernels do not take;
    - ``"clt"``: Gaussian, ``gaussian_sampler`` "clt" or "clt-prefix",
      no withdrawals;
    - ``"clt-nw"``: the same with a percent strategy and
      ``track_withdrawn=False`` (keep factors folded into the constants);
    - ``"clt-prefix"``: ``gaussian_sampler="clt-prefix"`` with a percent
      strategy, tracking the withdrawn total.

    Extreme-volatility models (1 + mean/100 <= 16 * std/100) stay on the
    ICDF: the CLT kernels take logs of growth products, and growth must be
    positive over the mix's bounded z support (|z| <= ~15.7).
    """
    if options.terminal_law:
        return "law"
    if model.kind != "gaussian":
        return "icdf"
    clt_asked = options.gaussian_sampler in ("clt", "clt-prefix")
    if clt_asked:
        a = 1.0 + float(model.mean_pct) / 100.0
        b = float(model.std_pct) / 100.0
        if a <= 16.0 * b:
            return "icdf"
    if clt_asked and strategy.kind == "none":
        return "clt"
    percent = strategy.kind in ("fixed_percent", "variable_percent")
    if clt_asked and percent and not options.track_withdrawn:
        return "clt-nw"
    if options.gaussian_sampler == "clt-prefix" and percent:
        return "clt-prefix"
    return "icdf"


def _check_slice(model, options, n_paths: int) -> None:
    """Raise for what the port does not run yet, naming its ROADMAP
    item (queue 1) so the next slice knows where to start."""
    if model.kind not in ("gaussian", "historical"):
        raise NotImplementedError(
            f"{model.kind!r} models are not ported yet (ROADMAP queue 1 "
            "item 11: Sobol and RQMC)"
        )
    if options.trajectory_dtype != "float32":
        raise NotImplementedError(
            f"trajectory_dtype={options.trajectory_dtype!r}: trajectories "
            "are not ported yet (ROADMAP queue 1 item 10)"
        )
    if n_paths > options.seed_segment_paths:
        raise NotImplementedError(
            f"n_paths={n_paths} exceeds one seed segment "
            f"({options.seed_segment_paths}); segment keys need threefry "
            "fold_in, not ported yet (ROADMAP queue 1 items 3 and 8)"
        )


def _validate_run(model, n_paths: int, per_dispatch: int, n_periods: int,
                  draws_bootstrap: bool = True) -> None:
    """Hard limits of the RNG index spaces: oversized runs error instead
    of wrapping (global path offsets are uint32)."""
    if n_paths <= 0:
        raise ValueError(f"n_paths must be positive, got {n_paths}")
    if n_periods <= 0:
        raise ValueError(f"n_periods must be positive, got {n_periods}")
    if n_paths > (1 << 32) - per_dispatch:
        raise ValueError(
            f"n_paths={n_paths} exceeds the uint32 global-path-offset space "
            f"(limit {(1 << 32) - per_dispatch} at this chunk size); split "
            "the run over multiple seeds instead"
        )
    if model.kind == "historical" and draws_bootstrap:
        n_table = int(np.asarray(model.returns_pct).shape[0])
        if n_table >= (1 << 15):
            raise ValueError(
                f"historical returns table has {n_table} rows; the exact "
                "integer bootstrap index map supports at most "
                f"{(1 << 15) - 1} rows — aggregate or subsample the series"
            )
    if isinstance(model, GaussianReturns):
        mean = float(np.asarray(model.mean_pct))
        std = float(np.asarray(model.std_pct))
        if std > 0 and (100.0 + mean) / std < 7.0:
            import warnings

            warnings.warn(
                f"GaussianReturns(mean={mean}, std={std}): monthly losses "
                "beyond -100% are reachable (growth factor < 0, "
                f"P ~ {0.5 * np.e ** (-0.5 * ((100 + mean) / std) ** 2):.1e}"
                " per draw); multiplicative compounding propagates the "
                "sign through the product",
                stacklevel=3,
            )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _resolve_device(options: EngineOptions) -> torch.device:
    dev = torch.device(options.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EngineOptions(device={options.device!r}) but torch finds no "
            "CUDA device; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels"
        )
    return dev


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamUpdate:
    """Partial statistics mid-run, pushed after every absorbed chunk:
    exact accumulated moments and histogram over the paths done so far."""

    done: int
    n_paths: int
    stats: np.ndarray              # packed power sums, float64
    hist: np.ndarray               # histogram counts incl. under/overflow
    spec: red.HistogramSpec
    target_amount: Optional[float]
    elapsed_s: float

    @property
    def moments(self) -> red.MomentSummary:
        return red.MomentSummary.from_packed(
            self.stats, self.target_amount is not None
        )

    def quantiles(self, qs) -> np.ndarray:
        if self.hist.sum() == 0:
            raise ValueError(
                "no histogram counts available (EngineOptions("
                "histogram=False), or no paths absorbed yet)"
            )
        return red.quantiles_from_histogram(self.spec, self.hist, qs)

    def prob_below(self, amount: float) -> float:
        if self.done == 0:
            return 0.0
        if self.hist.sum() == 0:
            raise ValueError(
                "no histogram available (EngineOptions(histogram=False))"
            )
        return red.prob_below_from_histogram(self.spec, self.hist, amount)


def _chunk_fn(model, strategy, n_periods, seed, v0f, options, dev):
    """The chunk function of this run, with its run-constant operands
    uploaded once: ``fn(offset=, valid=, n_paths=, **common)``, where
    ``offset`` is the chunk's first global path."""
    base = int(cuda_engine.seed_base_i32(seed).view(np.uint32))
    sampler = _effective_sampler(model, strategy, options)
    if sampler == "law":
        from stock_market_monte_carlo_torch.ops import terminal_law as tlaw

        _validate_terminal_law(strategy, options)
        fit = tlaw.fit_terminal_law(model, strategy, n_periods, v0f)
        law = torch.as_tensor(fit.operand(), device=dev)

        def fn(offset, **kw):
            return cuda_engine.law_chunk(
                law, seed_base=base ^ cuda_engine.LAW_STREAM_XOR,
                tile0=offset // KEY_TILE, inv_zmax=1.0 / tlaw.LAW_ZMAX, **kw)
        return fn

    keep_np = (_keep_factors_np(strategy, n_periods)
               if _is_multiplicative(strategy)
               else np.ones((n_periods,), np.float32))
    if sampler.startswith("clt"):
        variant = {"clt": "plain", "clt-nw": "keep_fold",
                   "clt-prefix": "prefix"}[sampler]
        a, b = cuda_engine.gaussian_ab(model.mean_pct, model.std_pct)
        arow, cs = clt.block_consts(
            a, b, n_periods, keep_np if variant == "keep_fold" else None)
        q = clt.q_tensor(dev)
        arow, cs = torch.as_tensor(arow, device=dev), torch.as_tensor(
            cs, device=dev)
        keep_rows = (torch.as_tensor(clt.keep_rows(keep_np, n_periods),
                                     device=dev)
                     if variant == "prefix" else None)
        p_tile = clt.tile_paths(variant)

        def fn(offset, **kw):
            return clt.clt_chunk(
                q, arow, cs, keep_rows, variant=variant,
                seed_base=base ^ clt.CLT_STREAM_XOR, tile0=offset // p_tile,
                **kw)
        return fn

    keep = torch.as_tensor(keep_np, device=dev)
    if model.kind == "historical":
        table_np, n_table = cuda_engine._pad_table(model.returns_pct)
        draw = dict(draw="historical", n_table=n_table)
        table = torch.as_tensor(table_np, device=dev)
    else:
        a, b = cuda_engine.gaussian_ab(model.mean_pct, model.std_pct)
        draw = dict(draw="gaussian", a=a, b=b)
        table = None
    amount = float(getattr(strategy, "amount", 0.0))

    def fn(offset, **kw):
        return cuda_engine.month_loop_chunk(
            table, keep, strategy=strategy.kind, amount=amount,
            n_periods=n_periods, seed_base=base, tile0=offset // KEY_TILE,
            **draw, **kw)
    return fn


def _to_host(out):
    """A chunk's (stats, hist[, finals]) tensors as numpy arrays."""
    return tuple(None if x is None else x.cpu().numpy() for x in out)


def simulate_stats(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    target_amount: Optional[float] = None,
    options: EngineOptions = EngineOptions(),
    mesh=None,
    progress=None,
    keep_final_values: Optional[bool] = None,
    checkpoint_path: Optional[str] = None,
    stream: Optional[Callable[[StreamUpdate], None]] = None,
) -> SimulationResult:
    """Fused simulate+reduce: O(1) host traffic regardless of n_paths.

    ``progress(done, n_paths)`` and ``stream(StreamUpdate)`` are called
    after every absorbed chunk; ``keep_final_values`` collects per-path
    finals on the host.
    """
    t_start = time.perf_counter()
    if mesh is not None:
        raise NotImplementedError(
            "mesh runs are not ported yet (ROADMAP queue 1 item 13: "
            "multi-GPU over torch.distributed)"
        )
    if checkpoint_path is not None:
        raise NotImplementedError(
            "checkpoint_path is not ported yet (ROADMAP queue 1 item 8)"
        )
    _check_slice(model, options, n_paths)
    dev = _resolve_device(options)
    _validate_run(model, n_paths, options.chunk_paths, n_periods,
                  draws_bootstrap=not options.terminal_law)
    v0f = float(initial_capital)
    if not (v0f > 0.0 and np.isfinite(v0f)):
        raise ValueError(
            f"initial_capital must be positive and finite, got "
            f"{initial_capital}"
        )
    keep_finals = (options.keep_final_values
                   if keep_final_values is None else keep_final_values)
    if keep_finals and 4 * n_paths > 8 << 30:
        raise ValueError(
            f"keep_final_values at n_paths={n_paths} would materialize "
            f"~{4 * n_paths / 2**30:.0f} GiB of finals on the host; use "
            "the fused statistics/histogram or split the run"
        )
    spec = make_histogram_spec(
        model, strategy, n_periods, initial_capital, options.histogram_bins
    )
    chunk_b = options.chunk_paths
    fn = _chunk_fn(model, strategy, n_periods, seed, v0f, options, dev)
    shift_c = analytic_moment_shift(model, strategy, n_periods)
    common = dict(
        v0=v0f, target=np.inf if target_amount is None else target_amount,
        shift=shift_c, log_lo=spec.log_lo, inv_w=1.0 / spec.width,
        hb=spec.n_bins + 2, with_hist=options.histogram,
        keep_finals=keep_finals,
    )
    # restores absolute units of the v0-normalized device power sums
    stat_scale = np.array(
        [1.0, v0f, v0f**2, v0f**3, v0f**4, v0f, v0f, 1.0, v0f], np.float64
    )

    total_stats = red.zero_packed_stats()
    total_hist = np.zeros(spec.n_bins + 2, np.float64)
    finals_parts = []
    pending = None  # (out, paths_done_after, valid)
    deferred = []   # (stats, hist, paths_done_after, valid)
    done = 0
    offset = 0
    remaining = n_paths
    defer_absorb = stream is None and progress is None and not keep_finals

    def _flush_deferred():
        # one stacked fetch per output kind, then the sequential f64
        # merges in chunk order
        nonlocal total_stats, total_hist, done
        if not deferred:
            return
        s_all = torch.stack([d[0] for d in deferred]).cpu().numpy()
        h_all = torch.stack([d[1] for d in deferred]).cpu().numpy()
        for i, (_, _, done_after, valid) in enumerate(deferred):
            total_stats, total_hist, done = _absorb(
                ((s_all[i], h_all[i]), done_after, valid), total_stats,
                total_hist, finals_parts, keep_finals, stat_scale, shift_c,
            )
        deferred.clear()

    def _report():
        if progress is not None:
            progress(done, n_paths)
        if stream is not None:
            stream(StreamUpdate(
                done=done, n_paths=n_paths, stats=total_stats,
                hist=total_hist, spec=spec, target_amount=target_amount,
                elapsed_s=time.perf_counter() - t_start,
            ))

    while remaining > 0:
        this_valid = min(remaining, chunk_b)
        if n_paths > chunk_b:
            b = chunk_b
        else:
            # bucket small runs to a power of two of at least one tile
            b = _round_up(this_valid, KEY_TILE)
            b = min(chunk_b, 1 << (b - 1).bit_length())
        out = fn(offset=offset, valid=this_valid, n_paths=b, **common)
        if defer_absorb:
            deferred.append((out[0], out[1], done + this_valid, this_valid))
            done += this_valid
            offset += b
            remaining -= this_valid
            if len(deferred) >= _DEFER_FLUSH_CHUNKS:
                _flush_deferred()
            continue
        # overlap: fetch chunk k-1 while chunk k runs on the device
        if pending is not None:
            total_stats, total_hist, done = _absorb(
                (_to_host(pending[0]),) + pending[1:], total_stats,
                total_hist, finals_parts, keep_finals, stat_scale, shift_c,
            )
            _report()
        pending = (out, done + this_valid, this_valid)
        offset += b
        remaining -= this_valid

    _flush_deferred()
    if pending is not None:
        total_stats, total_hist, done = _absorb(
            (_to_host(pending[0]),) + pending[1:], total_stats, total_hist,
            finals_parts, keep_finals, stat_scale, shift_c,
        )
    _report()

    finals = None
    if keep_finals:
        finals = np.concatenate(finals_parts)[:n_paths]
    moments = red.MomentSummary.from_packed(
        total_stats, target_amount is not None
    )
    if not options.track_withdrawn:
        moments = dataclasses.replace(moments, total_withdrawn=0.0)
    return SimulationResult(
        n_paths=n_paths,
        n_periods=n_periods,
        initial_capital=initial_capital,
        moments=moments,
        histogram_spec=spec if options.histogram else None,
        histogram_counts=total_hist if options.histogram else None,
        target_amount=target_amount,
        final_values=finals,
        elapsed_s=time.perf_counter() - t_start,
    )


def _absorb(pending, total_stats, total_hist, finals_parts, keep_finals,
            scale, shift=0.0):
    """Merge one chunk's host (stats, hist[, finals]) into the running
    float64 totals; ``pending`` = (out, paths_done_after, valid)."""
    out, done_after, valid = pending[:3]
    stats = np.asarray(out[0], np.float32).astype(np.float64)
    if shift != 0.0:
        # the device accumulated moments of d = f - c; restore the raw
        # power sums of f in float64 (binomial expansion about c)
        c = float(shift)
        n, d1, d2, d3, d4 = stats[0], stats[1], stats[2], stats[3], stats[4]
        s1 = d1 + n * c
        s2 = d2 + 2 * c * d1 + n * c**2
        s3 = d3 + 3 * c * d2 + 3 * c**2 * d1 + n * c**3
        s4 = d4 + 4 * c * d3 + 6 * c**2 * d2 + 4 * c**3 * d1 + n * c**4
        stats = stats.copy()
        stats[1:5] = [s1, s2, s3, s4]
    stats = stats * scale
    hist = np.asarray(out[1], np.float64)
    merged = np.concatenate([
        total_stats[:5] + stats[:5],
        [min(total_stats[5], stats[5]), max(total_stats[6], stats[6])],
        total_stats[7:] + stats[7:],
    ])
    if keep_finals:
        finals_parts.append(np.asarray(out[2], np.float32).ravel()[:valid])
    return merged, total_hist + hist, done_after


def simulate_final_values(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    options: EngineOptions = EngineOptions(),
    mesh=None,
    progress=None,
) -> np.ndarray:
    """Per-path final values (host np.ndarray)."""
    result = simulate_stats(
        model, n_paths, n_periods, initial_capital, seed, strategy,
        None, options, mesh, progress, keep_final_values=True,
    )
    return result.final_values


def simulate(config, model, strategy=NoWithdrawal(),
             options: EngineOptions = EngineOptions(), mesh=None,
             progress=None) -> SimulationResult:
    """Config-object entry point: run a ``SimulationConfig`` experiment."""
    return simulate_stats(
        model, config.n_paths, config.n_periods, config.initial_capital,
        config.seed, strategy, config.target_amount, options, mesh,
        progress,
    )


def run(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    target_amount: Optional[float] = None,
    options: EngineOptions = EngineOptions(),
    mesh=None,
    progress=None,
    keep_trajectories: int = 0,
    stream: Optional[Callable[[StreamUpdate], None]] = None,
) -> SimulationResult:
    """One-call experiment: fused stats (trajectories are not ported)."""
    if keep_trajectories > 0:
        raise NotImplementedError(
            "run(keep_trajectories>0) needs simulate_paths, whose draws "
            "come from threefry; not ported yet (ROADMAP queue 1 item 10)"
        )
    return simulate_stats(
        model, n_paths, n_periods, initial_capital, seed, strategy,
        target_amount, options, mesh, progress, stream=stream,
    )


def simulate_bands(*args, **kwargs):
    """Per-month trajectory bands: not ported yet."""
    raise NotImplementedError(
        "simulate_bands is not ported yet (ROADMAP queue 1 item 10: "
        "trajectories and bands)"
    )


def rqmc_estimate(*args, **kwargs):
    """Replicated-RQMC estimates: not ported yet."""
    raise NotImplementedError(
        "rqmc_estimate is not ported yet (ROADMAP queue 1 item 11: Sobol "
        "and RQMC)"
    )
