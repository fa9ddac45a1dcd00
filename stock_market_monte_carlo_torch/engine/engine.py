"""The simulation engine: a host chunk loop over the device chunk functions.

Counterpart of ``stock_market_monte_carlo_tpu/engine/engine.py`` on both
of its backends: ``simulate_stats``, ``simulate_final_values``,
``simulate``, ``run`` and ``simulate_paths`` on every model of
``models/market.py``. The sampler is chosen as the JAX package chooses it
(``_effective_sampler``). On the Pallas backend (``EngineOptions.backend``
"auto" or "pallas"): the month loop with the model's draw (counter-stream
historical or Gaussian ICDF, Sobol Gaussian or historical,
reference-parity historical), the CLT kernel (Gaussian,
``EngineOptions.gaussian_sampler`` "clt" / "clt-prefix"), or, with
``terminal_law=True``, the terminal law (counter-stream models). On the
XLA backend (``backend="xla"``): the threefry stream of ``ops/threefry.py``
through ``chunk_stats`` (the JAX package's XLA chunk: ``sample_growth``,
``compound_final``) on the CPU and the threefry loop kernel on the card,
or the terminal law's threefry draw; the Sobol historical model and the
reference stream draw the same points on both backends and keep their
month-loop kernels.

A run streams in chunks of ``chunk_paths`` paths. Each chunk reduces on
the device to one float32 stats row and a histogram
(``ops/cuda_engine.py``); the host merges the rows in float64, in chunk
order (``_absorb``). When nothing consumes per-chunk results (no progress
or stream callback, no finals), every chunk is launched before the first
host sync, in batches of at most ``_DEFER_FLUSH_CHUNKS``. Runs past
``EngineOptions.seed_segment_paths`` paths run as seed segments, each on
its own stream, as the JAX package runs them; Sobol runs never segment
(they split by ``index_offset``) and the reference-parity stream refuses
to (its paths would repeat).

Trajectories (``simulate_paths``, ``run(keep_trajectories=...)``) come
from ``sample_growth`` and ``compound_paths``: the threefry stream
(``ops/threefry.py``), the Sobol points (``ops/sobol.py``) or the
reference stream (``ops/rng.py``), plain torch on the device, as the JAX
package runs them as XLA. Bands are ``engine/bands.py``, replicated RQMC
``engine/rqmc.py``.

``simulate_stats(checkpoint_path=...)`` saves the merged totals after
every chunk (``engine/checkpoint.py``) and resumes a killed run from its
next chunk, bit for bit; under a checkpoint the absorb is not deferred.

Under a paths mesh (``parallel/mesh.py``: a ``torch.distributed`` process
group, every rank calling with the same arguments) a dispatch covers
``chunk_paths`` paths on each rank: rank i runs the chunk at ``offset +
b*i``. The ranks all-gather their chunk rows (stats row and histogram) and
every rank merges them in rank order, which is global chunk order, so a
mesh run's totals, histogram and finals equal a single-device run's at the
same ``chunk_paths`` bit for bit, and checkpoints resume across
topologies.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from stock_market_monte_carlo_torch.config import EngineOptions
from stock_market_monte_carlo_torch.engine.results import SimulationResult
from stock_market_monte_carlo_torch.models.market import (
    GaussianReturns,
    SobolGaussianReturns,
)
from stock_market_monte_carlo_torch.models.strategies import (
    FixedPercentWithdrawal,
    NoWithdrawal,
    VariablePercentWithdrawal,
)
from stock_market_monte_carlo_torch.ops import clt
from stock_market_monte_carlo_torch.ops import cuda_engine
from stock_market_monte_carlo_torch.ops import reductions as red
from stock_market_monte_carlo_torch.ops import sobol
from stock_market_monte_carlo_torch.ops import threefry
from stock_market_monte_carlo_torch.parallel.mesh import PathsMesh
from stock_market_monte_carlo_torch.utils.timing import span, spanned

KEY_TILE = cuda_engine.TILE_PATHS

# fold_in tag of seed-segment keys: segment s >= 1 draws under
# fold_in(key(seed), _SEG_FOLD + s) (the JAX package's engine._SEG_FOLD)
_SEG_FOLD = 0x5E6C0000
# fold_in tag of the scramble key (the Sobol models' digital shift)
_SCRAMBLE_FOLD = 0x50B0
_MODEL_KINDS = ("gaussian", "historical", "sobol_gaussian",
                "sobol_historical")

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
    if isinstance(model, (GaussianReturns, SobolGaussianReturns)):
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
    if isinstance(model, (GaussianReturns, SobolGaussianReturns)):
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


def _validate_terminal_law(model, strategy, options) -> None:
    """Structural preconditions of EngineOptions(terminal_law=True); the
    fit itself validates smoothness and keep > 0."""
    if (model.is_quasi
            or model.kind not in ("gaussian", "historical")
            or getattr(model, "rng", "counter") != "counter"):
        raise ValueError(
            "terminal_law=True needs the iid-month structure of a "
            "counter-rng gaussian or historical model (Sobol sequences "
            f"and reference-parity rng excluded); got {model.kind!r} "
            f"rng={getattr(model, 'rng', 'counter')!r}"
        )
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


def resolve_backend(options: EngineOptions) -> str:
    """The backend that runs: ``"xla"`` where asked for, else the kernels'
    ``"pallas"``. The JAX package's ``"auto"`` follows
    ``jax.default_backend()``; the port's is its kernels' counter stream
    (ROADMAP queue 3)."""
    return "xla" if options.backend == "xla" else "pallas"


def _effective_sampler(model, strategy, options: EngineOptions) -> str:
    """The sampler that runs (``engine._effective_sampler`` of the JAX
    package):

    - ``"law"``: ``terminal_law=True``;
    - ``"icdf"`` on the XLA backend otherwise, whatever
      ``gaussian_sampler`` says;
    - ``"icdf"``: the month loop; every model but ``GaussianReturns``
      (historical and Sobol kinds, whatever ``gaussian_sampler`` says),
      Gaussian models by default, and the cases below that the CLT kernels
      do not take;
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
    if resolve_backend(options) == "xla" or model.kind != "gaussian":
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


def _check_model(model) -> None:
    """Raise for an object that is none of the port's models."""
    if getattr(model, "kind", None) not in _MODEL_KINDS:
        raise TypeError(
            f"{type(model).__name__} is not a market model (kind "
            f"{getattr(model, 'kind', None)!r}; expected one of "
            f"{_MODEL_KINDS})"
        )


def _validate_run(model, n_paths: int, per_dispatch: int, n_periods: int,
                  draws_bootstrap: bool = True,
                  seg_paths: Optional[int] = None) -> None:
    """Hard limits of the RNG index spaces: oversized runs error instead
    of wrapping (global path offsets are uint32, Sobol positions below
    2^62). ``seg_paths`` (simulate_stats only) arms seed segmentation: runs
    larger than one segment re-key each segment's stream, so only the
    per-segment offset space must fit in uint32. Sobol runs do not
    segment; the reference-parity stream refuses to."""
    if n_paths <= 0:
        raise ValueError(f"n_paths must be positive, got {n_paths}")
    if n_periods <= 0:
        raise ValueError(f"n_periods must be positive, got {n_periods}")
    quasi = model.is_quasi
    if seg_paths is not None and n_paths > seg_paths and not quasi:
        if getattr(model, "rng", "counter") == "reference":
            raise ValueError(
                f"n_paths={n_paths} exceeds one seed segment "
                f"({seg_paths}), but reference-parity rng streams depend "
                "only on the global path id (state0 = pcg_hash(id + 1)): a "
                "fresh segment would repeat segment 0's paths exactly. Cap "
                "n_paths or run counter rng"
            )
        if seg_paths > (1 << 32) - per_dispatch:
            raise ValueError(
                f"seed_segment_paths={seg_paths} leaves no uint32 offset "
                f"headroom for a {per_dispatch}-path dispatch; lower "
                "seed_segment_paths or chunk_paths"
            )
    elif n_paths > (1 << 32) - per_dispatch:
        raise ValueError(
            f"n_paths={n_paths} exceeds the uint32 global-path-offset space "
            f"(limit {(1 << 32) - per_dispatch} at this chunk size); split "
            "the run over multiple seeds instead"
        )
    if model.kind.endswith("historical") and draws_bootstrap:
        n_table = int(np.asarray(model.returns_pct).shape[0])
        if n_table >= (1 << 15):
            raise ValueError(
                f"historical returns table has {n_table} rows; the exact "
                "integer bootstrap index map supports at most "
                f"{(1 << 15) - 1} rows — aggregate or subsample the series"
            )
    if model.kind.startswith("sobol"):
        n_dims = int(np.asarray(model.direction).shape[0])
        if n_periods > n_dims:
            raise ValueError(
                f"n_periods={n_periods} exceeds the model's {n_dims} Sobol "
                "dimensions; create the model with "
                f"n_periods>={n_periods} (direction numbers are "
                "per-dimension)"
            )
    if quasi:
        if n_paths > (1 << 31):
            raise ValueError(
                f"n_paths={n_paths} exceeds 2^31 paths per Sobol run; "
                "split the run and position each part with index_offset "
                "(the 2^62-deep index space)"
            )
        index_offset = getattr(model, "index_offset", 0)
        if index_offset + n_paths > (1 << 62):
            raise ValueError(
                f"index_offset {index_offset} + n_paths {n_paths} exceeds "
                "the 2^62 Sobol sequence"
            )
    if isinstance(model, (GaussianReturns, SobolGaussianReturns)):
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


def _xla_chunk_paths(n_periods: int, options: EngineOptions) -> int:
    """Paths a chunk of the XLA backend's CPU route, which materialises the
    (B, T) growth buffer: bounded to ~1 GiB as the JAX package bounds it.
    The card's kernels never materialise it and take ``chunk_paths``."""
    budget = 1 << 30
    b = budget // (n_periods * 4 * 3)
    b = max(KEY_TILE, (b // KEY_TILE) * KEY_TILE)
    return min(b, options.chunk_paths)


def _draws_threefry(model) -> bool:
    """Whether the XLA backend draws ``model`` from its own stream: the
    counter-stream models (threefry) and the Sobol Gaussian model (its
    points through ``normal_icdf``, not its kernel's u23 normal). The Sobol
    historical model and the reference stream draw the same points on
    both backends (tests/test_torch_xla_backend.py)."""
    if model.kind == "sobol_gaussian":
        return True
    return (model.kind in ("gaussian", "historical")
            and getattr(model, "rng", "counter") == "counter")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _segment_key(seed: int, segment: int) -> Tuple[int, int]:
    """The threefry key of a seed segment as two ints: ``key(seed)`` for
    segment 0, ``fold_in(key(seed), _SEG_FOLD + segment)`` after (the JAX
    package's ``_segment_keys``)."""
    key = threefry.key(seed)
    if segment:
        key = threefry.fold_in(key, _SEG_FOLD + segment)
    return threefry.key_data(key)


def _segment_base(seed: int, segment: int) -> int:
    """uint32 stream base of a seed segment: that of ``key(seed)`` for
    segment 0, of ``fold_in(key(seed), _SEG_FOLD + segment)`` after
    (engine._segment_keys and pallas_engine._seed_base_i32)."""
    key = threefry.key(seed)
    if segment:
        key = threefry.fold_in(key, _SEG_FOLD + segment)
    return cuda_engine.key_seed_base(*threefry.key_data(key))


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


def _scramble_key(seed: int, dev):
    """The Sobol models' scramble key: fold_in(key(seed), 0x50B0)."""
    return threefry.fold_in(threefry.key(seed, dev), _SCRAMBLE_FOLD)


def _segment_stream(seed: int, segment: int, options: EngineOptions):
    """What a chunk function draws a seed segment from: its threefry key
    on the XLA backend (``_segment_key``), else its uint32 stream base
    (``_segment_base``)."""
    if resolve_backend(options) == "xla":
        return _segment_key(seed, segment)
    return _segment_base(seed, segment)


def _chunk_fn(model, strategy, n_periods, v0f, options, dev, seed):
    """The chunk function of this run, with its run-constant operands
    uploaded once: ``fn(stream, offset, valid=, n_paths=, **common)``,
    where ``stream`` is the seed segment's (``_segment_stream``) and
    ``offset`` the chunk's first path in the segment. A Sobol model's
    digital shift comes from ``seed`` (its runs never segment)."""
    sampler = _effective_sampler(model, strategy, options)
    if resolve_backend(options) == "xla":
        if sampler == "law" or _draws_threefry(model):
            return _xla_chunk_fn(model, strategy, n_periods, v0f, options,
                                 dev, seed)
        # the same points as the kernels' stream, which takes no key
        kernel_fn = _chunk_fn(model, strategy, n_periods, v0f,
                              dataclasses.replace(options, backend="auto"),
                              dev, seed)
        base = _segment_base(seed, 0)
        return lambda key, offset, **kw: kernel_fn(base, offset, **kw)
    if sampler == "law":
        law, law_host, inv_zmax = _law_operand(model, strategy, n_periods,
                                               v0f, options, dev)

        def fn(base, offset, **kw):
            return cuda_engine.law_chunk(
                law, seed_base=base ^ cuda_engine.LAW_STREAM_XOR,
                tile0=offset // KEY_TILE, inv_zmax=inv_zmax,
                law_host=law_host, **kw)
        return fn

    keep_np = _keep_np(strategy, n_periods)
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

        def fn(base, offset, **kw):
            return clt.clt_chunk(
                q, arow, cs, keep_rows, variant=variant,
                seed_base=base ^ clt.CLT_STREAM_XOR, tile0=offset // p_tile,
                **kw)
        return fn

    keep = torch.as_tensor(keep_np, device=dev)
    table, draw = cuda_engine.draw_operands(
        model, dev, n_periods,
        sobol.digital_shift(_scramble_key(seed, dev), n_periods)
        if model.is_quasi else None)
    amount = float(getattr(strategy, "amount", 0.0))

    def fn(base, offset, **kw):
        return cuda_engine.month_loop_chunk(
            table, keep, strategy=strategy.kind, amount=amount,
            n_periods=n_periods, seed_base=base, tile0=offset // KEY_TILE,
            **draw, **kw)
    return fn


def _keep_np(strategy, n_periods: int) -> np.ndarray:
    """(T,) float32 keep factors of a multiplicative strategy, ones for a
    fixed amount (whose kernels read none)."""
    if _is_multiplicative(strategy):
        return _keep_factors_np(strategy, n_periods)
    return np.ones((n_periods,), np.float32)


@spanned("smmc.law_operand")
def _law_operand(model, strategy, n_periods, v0f, options, dev):
    """(law, law_host, inv_zmax) of a terminal-law run: the fitted
    operand on ``dev`` and on the host, and the normal's scale."""
    from stock_market_monte_carlo_torch.ops import terminal_law as tlaw

    _validate_terminal_law(model, strategy, options)
    law_host = tlaw.fit_terminal_law(model, strategy, n_periods,
                                     v0f).operand()
    return (torch.as_tensor(law_host, device=dev), law_host,
            1.0 / tlaw.LAW_ZMAX)


def _xla_chunk_fn(model, strategy, n_periods, v0f, options, dev, seed):
    """``_chunk_fn`` of the XLA backend's own draws, ``fn(key, offset,
    **kw)`` with ``key`` the segment's threefry key: the terminal law's
    threefry draw; else ``chunk_stats`` on the CPU and the threefry loop
    kernel on the card."""
    if options.terminal_law:
        law, law_host, inv_zmax = _law_operand(model, strategy, n_periods,
                                               v0f, options, dev)

        def fn(key, offset, **kw):
            return cuda_engine.law_chunk(
                law, seed_base=0, tile0=offset // KEY_TILE,
                inv_zmax=inv_zmax, law_host=law_host, draw="threefry",
                key=cuda_engine.law_key(key), **kw)
        return fn
    if dev.type == "cpu":
        scramble_key = _scramble_key(seed, dev)

        def fn(key, offset, **kw):
            root_key = tuple(torch.tensor(k, dtype=torch.int64, device=dev)
                             for k in key)
            return chunk_stats(model, strategy, root_key, scramble_key,
                               offset, n_periods=n_periods, **kw)
        return fn
    keep = torch.as_tensor(_keep_np(strategy, n_periods), device=dev)
    table, draw = cuda_engine.threefry_operands(
        model, dev, n_periods,
        sobol.digital_shift(_scramble_key(seed, dev), n_periods)
        if model.is_quasi else None)
    amount = float(getattr(strategy, "amount", 0.0))

    def fn(key, offset, **kw):
        return cuda_engine.threefry_loop_chunk(
            table, keep, strategy=strategy.kind, amount=amount,
            n_periods=n_periods, key=key, tile0=offset // KEY_TILE, **draw,
            **kw)
    return fn


def pinned_copy(x):
    """(host tensor, event or None): a CUDA tensor's copy into pinned host
    memory, queued on the current stream right behind the kernel that made
    it, and the event to wait on before reading it; a CPU tensor as it is.
    Waiting on that event waits for this chunk only, where ``.cpu()``
    would wait for every kernel queued before it (the next chunk's too)."""
    if x.device.type != "cuda":
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(x.device))
    return host, copied


def _check_mesh(mesh, dev=None) -> int:
    """The mesh's rank count, 1 without a mesh. Raises for an object that
    is no ``PathsMesh``, in a process outside the mesh, and for a device
    ``dev`` that is not the mesh's: a mesh never moves work to another
    device."""
    if mesh is None:
        return 1
    if not isinstance(mesh, PathsMesh):
        raise TypeError(
            f"mesh must be a PathsMesh (parallel.paths_mesh), got "
            f"{type(mesh).__name__}")
    mesh.check_member()
    if dev is not None:
        mesh.check_device(dev)
    return mesh.size


def _shard_valids(total_valid: int, b: int, n_dev: int):
    """Valid paths of each rank's ``b``-path shard of a dispatch of
    ``total_valid`` paths: clip(total_valid - b*i, 0, b)."""
    return [min(max(total_valid - b * i, 0), b) for i in range(n_dev)]


def _identity_out(dev, hb, keep_finals):
    """The outputs of a shard with no valid path, made without a launch:
    the merge's identity row (n 0, sums +0.0, min +inf, max -inf, count and
    withdrawn 0), zero cells and no finals (an empty tensor of them where
    the run keeps finals)."""
    f32 = dict(dtype=torch.float32, device=dev)
    stats = torch.cat([torch.zeros((5,), **f32),
                       torch.full((1,), float("inf"), **f32),
                       torch.full((1,), float("-inf"), **f32),
                       torch.zeros((2,), **f32)])
    return (stats, torch.zeros((hb,), **f32),
            torch.empty((0,), **f32) if keep_finals else None)


def _gathered(mesh, x, at_launch: bool):
    """``x`` stacked over the mesh's ranks in rank order, where this step
    is the one at which the mesh's backend exchanges (NCCL: tensors on the
    card, right after the launch; gloo: the host copies, once they are
    done); else ``x`` as it is."""
    if mesh is None or mesh.exchanges_on_device != at_launch:
        return x
    return mesh.gather(x)


def _fetch(parts, finals, mesh, b):
    """A dispatch's chunk parts (``_parts``) and finals on their way to the
    host: gathered on the card under NCCL, each part copied behind the
    chunk's kernel (``pinned_copy``) and the event after the last copy. A
    mesh pads each rank's finals to the shard's ``b`` paths."""
    if mesh is not None and finals is not None:
        finals = torch.nn.functional.pad(finals, (0, b - finals.numel()))
    copies = [pinned_copy(_gathered(mesh, p, True)) for p in parts]
    if finals is not None:
        finals = _gathered(mesh, finals, True)
    return ([host for host, _ in copies], finals), copies[-1][1]


def _to_host(fetched, mesh, n_dev):
    """A fetched dispatch as numpy arrays once its copies are done,
    gathered on the host under gloo: the (n_dev, 9) stats rows and
    (n_dev, hb) histograms in rank order (``_split``) and the (n_dev,
    paths) finals or None."""
    (parts, finals), copied = fetched
    with span("smmc.wait"):
        if copied is not None:
            copied.synchronize()
        stats, hist = _split(
            [_gathered(mesh, p, False).numpy().reshape(n_dev, -1)
             for p in parts])
        if finals is not None:
            finals = _gathered(mesh, finals.cpu(), False).numpy().reshape(
                n_dev, -1)
    return stats, hist, finals


def _parts(out, mesh):
    """What of a chunk travels to the host, chunk by chunk: its stats row
    and histogram as they are on one device; under a mesh packed into one
    float32 row, so a dispatch takes one collective."""
    if mesh is None:
        return out[0], out[1]
    return (torch.cat([out[0], out[1]]),)


def _split(parts):
    """(stats rows, histograms) of host parts from ``_parts`` whose last
    axis is a chunk's: the pair as it is, or the packed rows cut after the
    9 stats."""
    if len(parts) == 2:
        return parts[0], parts[1]
    return parts[0][..., :9], parts[0][..., 9:]


@spanned("smmc.simulate_stats")
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
    after every absorbed dispatch (one chunk, or one chunk a rank under a
    mesh); ``keep_final_values`` collects per-path finals on the host. Runs
    larger than ``options.seed_segment_paths`` are partitioned into seed
    segments, each drawing its own stream (segment 0 under the plain seed),
    merged by the same float64 host merges that combine chunks; no dispatch
    straddles a segment boundary.

    ``mesh`` (``parallel.paths_mesh``): every rank of the mesh calls with
    the same arguments, runs its shard of each dispatch on the mesh's
    device (which must be ``options.device``) and returns the same result,
    equal to a single-device run at the same ``chunk_paths`` bit for bit
    (a run of at most ``chunk_paths * size`` paths buckets its shards
    smaller: its sums then differ in the last bits). The callbacks fire on
    every rank.

    ``checkpoint_path`` saves the merged totals after every dispatch (rank
    0 writes under a mesh; every rank loads) and, when the file holds a
    checkpoint of the same run, resumes from it: the totals are then those
    of an uninterrupted run, bit for bit at the same ``chunk_paths``, on
    any number of ranks. A checkpoint of another run raises ValueError
    ("different run"); one written on the CPU resumes on the card and the
    other way round (both draw the same stream), one written by the JAX
    package does not (its float32 chunk sums run in another order).
    """
    t_start = time.perf_counter()
    with span("smmc.prepare"):
        _check_model(model)
        dev = _resolve_device(options)
        n_dev = _check_mesh(mesh, dev)
        rank = 0 if mesh is None else mesh.rank
        xla = resolve_backend(options) == "xla"
        chunk_b = options.chunk_paths
        if xla and dev.type == "cpu" and not options.terminal_law:
            chunk_b = _xla_chunk_paths(n_periods, options)
        per_dispatch = chunk_b * n_dev
        _validate_run(model, n_paths, per_dispatch, n_periods,
                      draws_bootstrap=not options.terminal_law,
                      seg_paths=options.seed_segment_paths)
        v0f = float(initial_capital)
        if not (v0f > 0.0 and np.isfinite(v0f)):
            raise ValueError(
                f"initial_capital must be positive and finite, got "
                f"{initial_capital}"
            )
        keep_finals = (options.keep_final_values
                       if keep_final_values is None else keep_final_values)
        if checkpoint_path is not None and keep_finals:
            raise ValueError(
                "checkpoint_path is not supported with keep_final_values "
                "(per-path buffers are not checkpointed)"
            )
        if keep_finals and 4 * n_paths > 8 << 30:
            raise ValueError(
                f"keep_final_values at n_paths={n_paths} would materialize "
                f"~{4 * n_paths / 2**30:.0f} GiB of finals on the host; use "
                "the fused statistics/histogram or split the run"
            )
        spec = make_histogram_spec(model, strategy, n_periods,
                                   initial_capital, options.histogram_bins)
        fn = _chunk_fn(model, strategy, n_periods, v0f, options, dev, seed)
        shift_c = analytic_moment_shift(model, strategy, n_periods)
        hb = spec.n_bins + 2
        common = dict(
            v0=v0f,
            target=np.inf if target_amount is None else target_amount,
            shift=shift_c, lo=spec.lo, log_lo=spec.log_lo,
            inv_w=1.0 / spec.width,
            hb=hb, with_hist=options.histogram,
            keep_finals=keep_finals,
        )
        # restores absolute units of the v0-normalized device power sums
        stat_scale = np.array(
            [1.0, v0f, v0f**2, v0f**3, v0f**4, v0f, v0f, 1.0, v0f],
            np.float64)
        base = _segment_stream(seed, 0, options)

    total_stats = red.zero_packed_stats()
    total_hist = np.zeros(spec.n_bins + 2, np.float64)
    finals_parts = []
    pending = None  # (fetched, shard valids, offset_after)
    deferred = []   # ((stats row, histogram), shard valids)
    done = 0
    offset = 0
    remaining = n_paths
    seg_paths = options.seed_segment_paths
    segmented = n_paths > seg_paths and not model.is_quasi
    seg = 0
    defer_absorb = (stream is None and progress is None
                    and checkpoint_path is None and not keep_finals)
    fingerprint = None
    if checkpoint_path is not None:
        from stock_market_monte_carlo_torch.engine import checkpoint as ckpt

        # the stream tag: the port (its chunk sums run in another order than
        # the JAX package's, so their checkpoints never mix), the backend
        # (the XLA backend's threefry stream is not the kernels'; its tag
        # names it, the kernels' tag is as it was), the effective sampler
        # (the prefix sampler with its kernel's finish order, which
        # rounds the withdrawn sums), and the histogram and segment tags (a
        # checkpoint of a histogram run must not resume into a run without
        # one, nor across seed_segment_paths). Neither the chunk size nor
        # the ranks: every chunk row is merged in global chunk order on any
        # topology
        sampler = _effective_sampler(model, strategy, options)
        if sampler == "clt-prefix":
            sampler = f"{sampler}-{clt.PREFIX_FINISH}"
        hist_tag = "" if options.histogram else "/nohist"
        seg_tag = f"/seg{seg_paths}" if segmented else ""
        fingerprint = ckpt.config_fingerprint(
            model, strategy, n_paths, n_periods, initial_capital, seed,
            target_amount, spec,
            f"torch/{'xla/' if xla else ''}streams3/{sampler}{hist_tag}"
            f"{seg_tag}",
        )
        state = ckpt.load(checkpoint_path, fingerprint)
        if state is not None:
            total_stats, total_hist = state.stats, state.hist
            done = state.paths_done
            offset = state.next_offset
            remaining = n_paths - done
            if segmented:
                # every dispatch of a segment but its last is full, so the
                # offset in the segment follows from the paths done
                seg, offset = divmod(done, seg_paths)
                base = _segment_stream(seed, seg, options)
        if mesh is not None:
            # the first collective: every rank must resume at one point
            here = torch.tensor([done, offset], dtype=torch.int64)
            if mesh.exchanges_on_device:
                here = here.to(mesh.device)
            seen = mesh.gather(here).cpu()
            if not bool((seen == seen[0]).all()):
                raise RuntimeError(
                    f"the mesh's ranks loaded different checkpoints from "
                    f"{checkpoint_path!r} ((paths done, next offset) by "
                    f"rank: {seen.tolist()}); every rank must read the same "
                    "file")
        if state is not None and progress is not None:
            progress(done, n_paths)

    def _checkpoint(next_offset):
        if checkpoint_path is not None and rank == 0:
            ckpt.save(checkpoint_path, ckpt.CheckpointState(
                fingerprint=fingerprint, next_offset=int(next_offset),
                paths_done=int(done), stats=total_stats, hist=total_hist,
            ))

    def _absorb_dispatch(stats, hist, finals, valids):
        # the ranks' rows in rank order: global chunk order
        nonlocal total_stats, total_hist, done
        for i, valid in enumerate(valids):
            total_stats, total_hist, done = _absorb(
                ((stats[i], hist[i], None if finals is None else finals[i]),
                 done + valid, valid), total_stats, total_hist,
                finals_parts, keep_finals, stat_scale, shift_c,
            )

    def _flush_deferred():
        # the deferred chunks' stats rows and histograms packed by one
        # cat, one fetch (and one collective under a mesh), then the
        # sequential f64 merges in chunk order
        if not deferred:
            return
        rows = torch.cat([t for parts, _ in deferred for t in parts])
        rows = _gathered(mesh, rows.view(len(deferred), -1), True)
        with span("smmc.wait"):
            rows = _gathered(mesh, rows.cpu(), False).numpy().reshape(
                n_dev, len(deferred), -1)
        with span("smmc.merge"):
            for j, (_, valids) in enumerate(deferred):
                _absorb_dispatch(rows[:, j, :9], rows[:, j, 9:], None,
                                 valids)
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

    def _absorb_pending():
        fetched, valids, offset_after = pending
        host = _to_host(fetched, mesh, n_dev)
        with span("smmc.merge"):
            _absorb_dispatch(*host, valids)
        _checkpoint(offset_after)

    while remaining > 0:
        cap = remaining
        if segmented:
            done_v = n_paths - remaining
            if done_v // seg_paths != seg:
                # a fresh segment: its own stream, offsets from 0
                seg = done_v // seg_paths
                offset = 0
                base = _segment_stream(seed, seg, options)
            cap = min(remaining, (seg + 1) * seg_paths - done_v)
        this_valid = min(cap, per_dispatch)
        if n_paths > per_dispatch:
            b = chunk_b
        else:
            # bucket small runs to a power of two of at least one tile
            b = _round_up(_round_up(this_valid, n_dev) // n_dev, KEY_TILE)
            b = min(chunk_b, 1 << (b - 1).bit_length())
        valids = _shard_valids(this_valid, b, n_dev)
        with span("smmc.dispatch"):
            out = (fn(base, offset + b * rank, valid=valids[rank],
                      n_paths=b, **common)
                   if valids[rank] else _identity_out(dev, hb, keep_finals))
        offset += b * n_dev
        remaining -= this_valid
        if defer_absorb:
            deferred.append((out[:2], valids))
            if len(deferred) >= _DEFER_FLUSH_CHUNKS:
                _flush_deferred()
            continue
        # overlap: absorb dispatch k-1 (its copies queued behind its
        # kernel) while dispatch k runs on the device
        if pending is not None:
            _absorb_pending()
            _report()
        pending = (_fetch(_parts(out, mesh), out[2], mesh, b), valids,
                   offset)

    _flush_deferred()
    if pending is not None:  # None when a checkpoint was already complete
        _absorb_pending()
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


# ---------------------------------------------------------------------------
# Trajectories: the threefry stream, plain torch on the device.
# ---------------------------------------------------------------------------


def sample_growth(model, root_key, scramble_key, path_offset, shape):
    """(B, T) float32 growth factors (100 + r)/100 for paths [path_offset,
    path_offset + B) on the device of ``root_key`` (a threefry key).

    Counter-stream models draw from the threefry stream of the segment
    keyed by ``root_key``: ``B`` is a multiple of KEY_TILE, each 8192-path
    tile drawing under ``fold_in(root_key, tile)``, so a path's draws
    depend only on (seed, its position). Sobol models draw their points at
    sequence positions ``index_offset + path_offset + [0, B)``, shifted by
    ``scramble_key``; the reference stream draws from the path ids."""
    b, t = shape
    dev = root_key[0].device
    if model.is_quasi:
        r = model.sample_returns_pct_quasi(scramble_key, path_offset, shape)
    elif getattr(model, "rng", "counter") == "reference":
        r = model.sample_returns_pct_reference(path_offset, shape, dev)
    else:
        if b % KEY_TILE:
            raise ValueError(f"{b} paths: not a multiple of {KEY_TILE}")
        first = (int(path_offset) & cuda_engine.MASK32) // KEY_TILE
        tiles = (first + torch.arange(b // KEY_TILE, device=dev)
                 ) & cuda_engine.MASK32
        r = model.sample_returns_pct(threefry.fold_in(root_key, tiles),
                                     (KEY_TILE, t)).reshape(b, t)
    return (100.0 + r) * cuda_engine._f32(0.01)


def compound_paths(growth, v0, strategy):
    """(B, T+1) trajectories from (B, T) growth, month 0 = v0. Percent
    strategies as v0 * cumprod(growth * keep); a fixed amount month by
    month as max(V * g - amount, 0)."""
    b, t = growth.shape
    v0 = cuda_engine._f32(v0)
    first = torch.full((b, 1), v0, dtype=torch.float32, device=growth.device)
    if _is_multiplicative(strategy):
        keep = torch.as_tensor(_keep_factors_np(strategy, t),
                               device=growth.device)
        return torch.cat([first, v0 * torch.cumprod(growth * keep, dim=1)],
                         dim=1)
    amount = cuda_engine._f32(strategy.amount)
    cols = [first[:, 0]]
    for m in range(t):
        cols.append(torch.clamp_min(cols[-1] * growth[:, m] - amount, 0.0))
    return torch.stack(cols, dim=1)


def compound_final(growth, v0, strategy):
    """(B,) final values and (B,) withdrawn totals from (B, T) growth (the
    JAX package's ``compound_final``): percent strategies and none as v0 *
    prod(growth * keep), the withdrawn total summing (v0 * the shifted
    cumprod * growth) * (1 - keep); a fixed amount month by month as
    max(V * g - amount, 0), withdrawing the difference."""
    b, t = growth.shape
    v0 = cuda_engine._f32(v0)
    f32 = dict(dtype=torch.float32, device=growth.device)
    if _is_multiplicative(strategy):
        keep = torch.as_tensor(_keep_factors_np(strategy, t),
                               device=growth.device)
        gk = growth * keep
        finals = v0 * torch.prod(gk, dim=1)
        if strategy.kind == "none":
            return finals, torch.zeros((b,), **f32)
        prev = torch.cat([torch.ones((b, 1), **f32),
                          torch.cumprod(gk, dim=1)[:, :-1]], dim=1)
        grown = v0 * prev * growth
        return finals, torch.sum(grown * (1.0 - keep), dim=1)
    amount = cuda_engine._f32(strategy.amount)
    value = torch.full((b,), v0, **f32)
    wsum = torch.zeros((b,), **f32)
    for m in range(t):
        grown = value * growth[:, m]
        value = torch.clamp_min(grown - amount, 0.0)
        wsum = wsum + (grown - value)
    return value, wsum


def chunk_stats(model, strategy, root_key, scramble_key, path_offset, *,
                n_periods, valid, n_paths, v0, target, shift, lo, log_lo,
                inv_w, hb, with_hist, keep_finals):
    """One chunk of the XLA backend in plain torch (the JAX package's
    ``chunk_stats``): ``sample_growth`` of paths [path_offset, path_offset
    + n_paths) under the segment's ``root_key``, ``compound_final``, then
    the stats row and histogram of the first ``valid`` paths as the
    kernels make them (``cuda_engine._epilogue``: float64 sums where the
    JAX package sums in float32). Returns (stats, hist, finals-or-None)."""
    growth = sample_growth(model, root_key, scramble_key, path_offset,
                           (n_paths, n_periods))
    finals, withdrawn = compound_final(growth, v0, strategy)
    stats, hist = cuda_engine._epilogue(finals, withdrawn, valid, v0, target,
                                        shift, lo, log_lo, inv_w, hb,
                                        with_hist)
    return stats, hist, (finals[:valid] if keep_finals else None)


def _check_paths(n_paths: int, n_periods: int, dtype: str) -> None:
    """simulate_paths' argument checks, which run() makes before its stats
    run."""
    est_bytes = 4 * (n_paths + KEY_TILE) * (n_periods + 1) * 3
    if est_bytes > 8 << 30:
        raise ValueError(
            f"simulate_paths would materialize ~{est_bytes / 2**30:.0f} GiB "
            f"of trajectories ({n_paths} paths x {n_periods + 1} months); "
            "use simulate_stats/simulate_final_values for statistics at "
            "scale, or cap the trajectory count (run(keep_trajectories=N))."
        )
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32|bfloat16, got {dtype!r}")


def simulate_paths(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    path_offset: int = 0,
    dtype: str = "float32",
    options: EngineOptions = EngineOptions(),
) -> np.ndarray:
    """(n_paths, n_periods+1) float32 host trajectories, month 0 = capital:
    rows [path_offset, path_offset + n_paths) of the seed's stream, for
    visualization-scale path counts (memory is O(n_paths * n_periods)).

    The window aligns down to the 8192-path tile and the lead rows are
    dropped, so any ``path_offset`` returns exactly those rows.
    ``dtype="bfloat16"`` rounds the trajectories to bfloat16; the array is
    float32 either way. Runs on ``options.device``, in chunks of two
    tiles.
    """
    _check_paths(n_paths, n_periods, dtype)
    _check_model(model)
    dev = _resolve_device(options)
    lead = int(path_offset) % KEY_TILE
    base = int(path_offset) - lead
    b = _round_up(lead + n_paths, KEY_TILE)
    root_key = threefry.key(seed, dev)
    scramble_key = _scramble_key(seed, dev)
    out = np.empty((n_paths, n_periods + 1), np.float32)
    chunk = 2 * KEY_TILE
    for off in range(0, b, chunk):
        rows = min(chunk, b - off)
        part = compound_paths(
            sample_growth(model, root_key, scramble_key, base + off,
                          (rows, n_periods)), initial_capital, strategy)
        if dtype == "bfloat16":
            part = part.to(torch.bfloat16).to(torch.float32)
        # window rows [off, off + rows) against the kept [lead, lead + n)
        lo, hi = max(off, lead), min(off + rows, lead + n_paths)
        if hi > lo:
            out[lo - lead:hi - lead] = part[lo - off:hi - off].cpu().numpy()
    return out


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
    """One-call experiment: fused stats plus, with ``keep_trajectories``,
    that many trajectories (``simulate_paths`` in
    ``options.trajectory_dtype``) for fan plots."""
    k = min(keep_trajectories, n_paths)
    if k > 0:
        _check_paths(k, n_periods, options.trajectory_dtype)
    result = simulate_stats(
        model, n_paths, n_periods, initial_capital, seed, strategy,
        target_amount, options, mesh, progress, stream=stream,
    )
    if k > 0:
        result.trajectories = simulate_paths(
            model, k, n_periods, initial_capital, seed, strategy,
            dtype=options.trajectory_dtype, options=options,
        )
    return result

