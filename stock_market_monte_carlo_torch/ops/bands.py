"""The per-month band kernels: the month loop with a reduction of every
month's values, as hand-written CUDA kernels and their plain PyTorch
versions.

Counterpart of ``stock_market_monte_carlo_tpu/ops/pallas_bands.py``:

- ``month_hist_chunk`` replaces ``_build_bands_kernel`` (``pl.pallas_call``
  in ``_build_bands_call``), run by ``pallas_chunk_month_hist``: each
  month's values binned into ``n_bins + 2`` cells at
  ``clip(floor(log(max(V, 1e-37)) * A_t + B_t) + 1, 0, n_bins + 1)``;
- ``month_cdf_chunk`` replaces ``_build_cdf_kernel`` (``_build_cdf_call``),
  run by ``pallas_chunk_month_cdf``: each month, the count of values below
  each of K thresholds ``exp(A_t + kk_k * B_t)``, where kk_k is k except
  the guard rows 0 and K-1 at ``kappa_lo`` and ``kappa_hi``;
- ``counts_below_tile`` replaces the test-local kernel around
  ``_counts_below_tile`` (``tests/test_bands.py``): one tile's counts below
  K unsorted threshold rows, launched by no run of the engine.

Source ``csrc/bands.cu``. Both run the month step of ``csrc/month_loop.cu``
(historical bootstrap or Gaussian ICDF draw on the arithmetic counter
stream) with the keep factor of a percent strategy folded into the growth
first, ``V *= g * keep``, as the JAX kernels do; so a seed, offset and
months give the sample of the stats kernels. Both emit months 1..T of one
chunk; month 0 (every path at v0) is the caller's. Counts are int32 (at
most 2^24 per cell per chunk).

Each wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no fallback. Launches
count under ``cuda_engine.LAUNCHES["bands_hist"]``, ``["bands_cdf"]`` and
``["counts_below_tile"]``. Both band kernels find a value's cell by a
guess on the month's log grid and a correction against its thresholds or,
for the histogram, its cell edges (``hist_edges``: the least float of each
cell); ``cdf_cell_twin`` and ``hist_cell_twin`` are that arithmetic in
plain torch, ``hist_plan_twin`` and ``hist_work_twin`` the histogram's
split of a chunk into windows of months and warp items, for the tests.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stock_market_monte_carlo_torch.ops import cuda_engine as ce

TILE_PATHS = ce.TILE_PATHS
CDF_THRESHOLDS = 32
# the JAX kernel's VMEM budget for its (T*K, 128) int32 accumulator;
# cdf_supported keeps its cap so the same inputs are accepted
_CDF_VMEM_CAP = 8 << 20
# shared memory of one block (the table, and a month's histogram cells and
# their edges, or the (T, K+1) counts) must fit the opt-in maximum
_MAX_SMEM = 227 * 1024
# paths of a warp item of the band kernels (32 lanes x 8 paths)
_ITEM_PATHS = 256
# the smallest value the cell arithmetic takes the log of
_TINY = 1e-37
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def bands_supported(model, strategy_kind: str) -> bool:
    """The band kernels' models and strategies
    (``pallas_bands.bands_supported``)."""
    return (
        model.kind in ("gaussian", "historical")
        and getattr(model, "rng", "counter") == "counter"
        and strategy_kind in ("none", "fixed_percent", "variable_percent")
    )


def cdf_supported(model, strategy_kind: str, n_periods: int,
                  n_thresholds: int = CDF_THRESHOLDS) -> bool:
    """CDF band mode's inputs (``pallas_bands.cdf_supported``): the band
    kernels' models, K a multiple of 8, and T*K under the JAX kernel's
    accumulator cap."""
    return (
        bands_supported(model, strategy_kind)
        and n_thresholds % 8 == 0
        and n_thresholds >= 8
        and n_periods * n_thresholds * 128 * 4 <= _CDF_VMEM_CAP
    )


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _month_values(dev, table, keep, *, draw, n_table, a, b, n_periods,
                  seed_base, tile0, n_paths, v0):
    """The chunk's running values on ``dev`` after each month: yields
    ``(t, total)`` for t = 0..T-1 with ``total`` the (tiles, 64, 128)
    float32 values after month t+1. The stream and the draw are
    ``month_loop_chunk_plain``'s (``cuda_engine.month_growth``); the keep
    factor multiplies the growth before the compounding."""
    growth = ce.month_growth(dev, table, draw=draw, n_table=n_table, a=a,
                             b=b, seed_base=seed_base, tile0=tile0,
                             n_paths=n_paths)
    total = torch.full((n_paths // TILE_PATHS, ce.TILE_ROWS, 128),
                       ce._f32(v0), dtype=torch.float32, device=dev)
    for t in range(n_periods):
        g = growth(t)
        if keep is not None:
            g = g * keep[t]
        total = total * g
        yield t, total


def month_hist_chunk_plain(table, keep, coef_a, coef_b, *, n_bins, valid,
                           coef_a_host=None, edges=None, **kw):
    """Plain PyTorch version of the band-histogram kernel: (T, n_bins+2)
    int32 counts of the first ``valid`` paths of the chunk, months 1..T.
    ``kw`` as ``_month_values``; ``coef_a_host`` and ``edges`` are the
    kernel's and unused here."""
    floor_v = torch.full((), ce._f32(1e-37), device=coef_a.device)
    rows = []
    for t, total in _month_values(coef_a.device, table, keep, **kw):
        logv = torch.log(torch.fmax(total.reshape(-1)[:valid], floor_v))
        x = torch.floor(logv * coef_a[t] + coef_b[t])
        idx = torch.clamp(x, -1.0, float(n_bins)).to(torch.int64) + 1
        rows.append(torch.bincount(idx, minlength=n_bins + 2))
    return torch.stack(rows).to(torch.int32)


def hist_cells(v, coef_a, coef_b, n_bins):
    """int64 cells of float32 values ``v`` under bin coefficients
    ``coef_a``, ``coef_b`` (broadcast against ``v``): clamp(floor(log(
    fmax(v, 1e-37)) * A + B), -1, n_bins) + 1, in ``month_hist_chunk_plain``'s
    float32 operations."""
    logv = torch.log(torch.fmax(v, torch.full((), ce._f32(_TINY),
                                               device=v.device)))
    x = torch.floor(logv * coef_a + coef_b)
    return torch.clamp(x, -1.0, float(n_bins)).to(torch.int64) + 1


def hist_edges(coef_a, coef_b, n_bins):
    """(T, n_bins+1) float32 cell edges of the band histogram: edge c-1 of
    month t is the least float32 x >= 1e-37 (or +inf) whose cell
    (``hist_cells`` under A_t > 0, B_t) is at least c, c = 1..n_bins+1.
    Where the cell does not decrease as x grows (``torch.log`` does not
    decrease over the floats, which the card's tests check for its log),
    the cell of V is then the number of its month's edges that fmax(V,
    1e-37) is not below: NaN and values below 1e-37 in the cell of 1e-37,
    +inf in the last. A bisection over the float32 bit patterns from 1e-37
    to +inf, every edge at once, on ``coef_a``'s device with its log."""
    dev = coef_a.device
    c = torch.arange(1, n_bins + 2, device=dev)
    ca, cb = coef_a[:, None], coef_b[:, None]
    lo_bits = int(np.float32(_TINY).view(np.int32)) - 1
    hi_bits = int(np.float32(np.inf).view(np.int32))
    # lo: below the edge (the pattern before 1e-37 stands for "none");
    # hi: at or above it
    lo = torch.full((coef_a.numel(), n_bins + 1), lo_bits, dtype=torch.int64,
                    device=dev)
    hi = torch.full_like(lo, hi_bits)
    for _ in range((hi_bits - lo_bits).bit_length()):
        gap = hi - lo > 1
        mid = lo + (hi - lo) // 2
        up = hist_cells(mid.to(torch.int32).view(torch.float32), ca, cb,
                        n_bins) >= c
        hi = torch.where(gap & up, mid, hi)
        lo = torch.where(gap & ~up, mid, lo)
    return hi.to(torch.int32).view(torch.float32).contiguous()


def hist_guess_coefficients(coef_a, coef_b):
    """(T, 2) float32 (a_t, c_t) of the band histogram kernel's guess of a
    cell, floor((log2 V - a_t) * c_t) clamped to [1, n_bins]: c_t = A_t ln 2,
    a_t = -(B_t + 1) / c_t, so that in exact arithmetic the guess is
    floor(ln V * A_t + B_t) + 1, the cell."""
    c = coef_a * _LN2
    return torch.stack((-(coef_b + 1.0) / c, c), dim=1).contiguous()


def cdf_thresholds(coef_a, coef_b, kappa_lo, kappa_hi, n_thresholds):
    """(T, K) float32 thresholds exp(A_t + kk_k * B_t): kk_k = k, the
    guard rows 0 and K-1 at ``kappa_lo`` / ``kappa_hi``."""
    kk = torch.arange(n_thresholds, dtype=torch.float32,
                      device=coef_a.device)
    # fill_ takes the value as a kernel argument; an indexed assignment
    # would copy it from the host and wait for the card
    kk[0].fill_(ce._f32(kappa_lo))
    kk[-1].fill_(ce._f32(kappa_hi))
    return torch.exp(coef_a[:, None] + kk[None, :] * coef_b[:, None])


def month_cdf_chunk_plain(table, keep, coef_a, coef_b, *, kappa_lo,
                          kappa_hi, n_thresholds, valid, coef_b_host=None,
                          **kw):
    """Plain PyTorch version of the counts-below kernel: (T, K) int32
    counts of the first ``valid`` paths with V_t below each threshold
    (``cdf_thresholds``), months 1..T. ``kw`` as ``_month_values``;
    ``coef_b_host`` is the kernel's and unused here (the plain count needs
    no order of the thresholds)."""
    thr = cdf_thresholds(coef_a, coef_b, kappa_lo, kappa_hi, n_thresholds)
    rows = []
    for t, total in _month_values(coef_a.device, table, keep, **kw):
        v = total.reshape(-1)[:valid]
        rows.append((v[:, None] < thr[t][None, :]).sum(0))
    return torch.stack(rows).to(torch.int32)


def cdf_guess_coefficients(coef_a, coef_b):
    """(T, 2) float32 (a_t, c_t) of the counts-below kernel's guess
    floor((log2 V - a_t) * c_t): a_t = (A_t - B_t) log2 e, c_t = ln 2 / B_t,
    so that in exact arithmetic the guess is floor((ln V - A_t) / B_t) + 1,
    the cell of V on the thresholds' log grid A_t + k * B_t."""
    return torch.stack(((coef_a - coef_b) * _LOG2E, _LN2 / coef_b),
                       dim=1).contiguous()


def cdf_cell_twin(v, thr, coef_a, coef_b, guess=cdf_guess_coefficients):
    """The band kernels' cell arithmetic (``csrc/bands.cu`` ``cdf_guess``
    and ``cdf_walk``) in plain torch, for the tests: int64 j per float32
    value of ``v``, the number of the month's K ascending thresholds
    ``thr`` (K,) it is not below. The guess from ``guess`` (the counts
    below thresholds' ``cdf_guess_coefficients``, or the histogram's
    ``hist_guess_coefficients`` with its edges as ``thr``) of the month's
    float32 A_t, B_t (``coef_a``, ``coef_b``), clamped in float to [1,
    K-1], then steps down while v < thr[j-1] and up while !(v < thr[j]),
    so the result is #{k : !(v < thr[k])} exactly. The kernel's guess
    takes the fast log2 (``__log2f``) where this takes ``torch.log2``, and
    checks a guess before it walks; the walk makes the two results the
    same."""
    k = thr.shape[0]
    f32 = dict(dtype=torch.float32, device=v.device)
    a, c = guess(torch.as_tensor(coef_a, **f32).reshape(1),
                 torch.as_tensor(coef_b, **f32).reshape(1))[0]
    lg = torch.log2(torch.fmax(v, torch.full((), ce._f32(_TINY), **f32)))
    x = torch.fmin(torch.fmax(torch.floor((lg - a) * c),
                              torch.ones((), **f32)),
                   torch.full((), float(k - 1), **f32))
    j = x.to(torch.int64)
    while True:
        down = (j > 0) & (v < thr[(j - 1).clamp(min=0)])
        if not bool(down.any()):
            break
        j = j - down.long()
    while True:
        up = (j < k) & ~(v < thr[j.clamp(max=k - 1)])
        if not bool(up.any()):
            break
        j = j + up.long()
    return j


def hist_plan_twin(valid, n_periods, n_cells, n_table=0, sms=132,
                   blocks_per_sm=1):
    """The band-histogram kernel's launch plan (``csrc/bands.cu`` ``plan``,
    mode 0) in plain Python, for the tests: {"window", "windows", "grid",
    "threads"} for a ``valid``-path chunk of ``n_periods`` months of
    ``n_cells`` cells beside an ``n_table``-row table (0: the Gaussian
    draw), on a card of ``sms`` SMs holding ``blocks_per_sm`` blocks. The
    fewest windows whose months' counts fit in shared memory beside the
    table, evened out; the blocks that fit at once, or fewer where the
    chunk has fewer warp items than their warps. Raises where one month
    does not fit."""
    tab = 4 * -(-n_table // 128) * 128
    month = 4 * (2 * n_cells - 1)    # the cells and their edges
    if n_periods < 1 or n_cells < 3 or tab + month > _MAX_SMEM:
        raise ValueError(f"a month of {n_cells} cells does not fit")
    most = min(n_periods, (_MAX_SMEM - tab) // month)
    windows = -(-n_periods // most)
    threads = 1024
    items = -(-valid // _ITEM_PATHS)
    grid = max(1, min(sms * max(1, blocks_per_sm),
                      -(-items // (threads // 32))))
    return dict(window=-(-n_periods // windows), windows=windows, grid=grid,
                threads=threads)


def hist_work_twin(valid, n_periods, window, grid, warps=32):
    """How often the band-histogram kernel bins each path it simulates,
    summed over the months, as its loops split the chunk (``csrc/bands.cu``
    ``hist_kernel``), in plain torch for the tests: an int32 tensor over
    the chunk's 256-path warp items' paths. Each of the ``grid`` x
    ``warps`` warps walks a contiguous range of warp items (ranges differ
    by at most one item) for each window of ``window`` months; lane l holds
    the paths tile * 8192 + pos0 + 32 i (i < 8) of an item, pos0 = (item %
    32) * 256 + l, and bins path i while 32 i < valid - tile * 8192 -
    pos0."""
    n_items = -(-valid // _ITEM_PATHS)
    n_warps = grid * warps
    gw = torch.arange(n_warps, dtype=torch.int64)
    first, last = gw * n_items // n_warps, (gw + 1) * n_items // n_warps
    # the warps that walk each item
    edges = torch.zeros(n_items + 1, dtype=torch.int64)
    edges.index_add_(0, first, torch.ones_like(first))
    edges.index_add_(0, last, -torch.ones_like(last))
    walkers = edges.cumsum(0)[:n_items, None]
    item = torch.arange(n_items, dtype=torch.int64)[:, None]
    tile = item // (TILE_PATHS // _ITEM_PATHS)
    pos0 = (item % (TILE_PATHS // _ITEM_PATHS)) * _ITEM_PATHS + torch.arange(
        32, dtype=torch.int64)
    live = valid - tile * TILE_PATHS - pos0
    counted = torch.zeros(n_items * _ITEM_PATHS, dtype=torch.int32)
    for t0 in range(0, n_periods, window):
        months = min(t0 + window, n_periods) - t0
        for i in range(_ITEM_PATHS // 32):
            path = (tile * TILE_PATHS + pos0 + 32 * i).reshape(-1)
            binned = (walkers * (32 * i < live) * months).reshape(-1)
            counted.index_add_(0, path, binned.to(torch.int32))
    return counted


def hist_cell_twin(v, edges, coef_a, coef_b):
    """The band-histogram kernel's cell arithmetic in plain torch, for the
    tests: ``cdf_cell_twin`` of fmax(v, 1e-37) against the month's edges
    (``hist_edges``, (n_bins+1,)) with the histogram's guess
    (``hist_guess_coefficients``). Equal to ``hist_cells`` of v where the
    edges are the cells' least values."""
    x = torch.fmax(v, torch.full((), ce._f32(_TINY), device=v.device))
    return cdf_cell_twin(x, edges, coef_a, coef_b,
                         guess=hist_guess_coefficients)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _host_coefficients(host, name, n_periods):
    """A host copy of bin or threshold coefficients as float32 numpy,
    checked to be (n_periods,)."""
    if host is None:
        raise ValueError(f"the kernel needs {name}, a host copy of "
                         f"{name[:-5]}, to check its order")
    host = np.asarray(host, dtype=np.float32)
    if host.shape != (n_periods,):
        raise ValueError(f"{name} has shape {host.shape}, expected "
                         f"({n_periods},)")
    return host


def _launcher(mode, table, keep, coef_a, coef_b, *, draw, n_table, a, b,
              n_periods, seed_base, tile0, valid, n_paths, v0, n_cells,
              kappa_lo=0.0, kappa_hi=0.0, coef_b_host=None,
              coef_a_host=None, edges=None):
    """Checked inputs of one band chunk on a CUDA device -> ``(launch,
    counts)``: ``launch()`` runs the kernel (``mode`` 0: histogram of
    ``n_cells`` cells, 1: counts below ``n_cells`` thresholds) into a
    zeroed int32 (T, cells) tensor on the current stream; ``counts()``
    returns the (T, n_cells) result. Mode 0 takes ``coef_a_host``, a host
    copy of ``coef_a``, and checks A_t > 0 on it, so that the cells do not
    decrease as V grows; its cell edges are ``edges`` ((T, n_cells-1),
    ``hist_edges``), or computed here; it keeps its running values
    between windows of months in a scratch of the chunk's warp items. Mode
    1 takes ``coef_b_host``, a host copy of ``coef_b``, and checks the
    order of the thresholds on it. A check of the CUDA tensors would wait
    for the card."""
    from stock_market_monte_carlo_torch.ops._build import load_library

    dev = coef_a.device
    ce._check_chunk(dev, "band", valid, n_paths)
    ce._check(coef_a, "coef_a", dev, n_periods)
    ce._check(coef_b, "coef_b", dev, n_periods)
    if keep is not None:
        ce._check(keep, "keep", dev, n_periods)
    if draw == "historical":
        if not 0 < n_table < (1 << 15):
            raise ValueError(f"table length {n_table} outside [1, 2^15)")
        k_chunks = -(-n_table // 128)
        ce._check(table, "table", dev, k_chunks * 128)
        tail_n = n_table - 128 * (k_chunks - 1)
    elif draw == "gaussian":
        if table is not None:
            raise ValueError("the Gaussian draw takes no table")
        k_chunks = tail_n = n_table = 0
    else:
        raise ValueError(f"unknown draw {draw!r}")
    # shared memory: the table, then a month's cells and edges (mode 0,
    # which takes windows of as many months as fit), or 8 warps' month rows
    # and pairs and every month's K+1 cells (mode 1, one copy of its count
    # table; it takes more copies where they fit)
    cells = n_cells + mode
    smem = 4 * (k_chunks * 128 + (2 * cells - 1 if mode == 0
                                  else 8 * 3 * n_cells + n_periods * cells))
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{n_periods} months of {n_cells} cells and a {n_table}-row "
            f"table need {smem} bytes of shared memory per block (at most "
            f"{_MAX_SMEM})")
    if mode == 0:
        # the kernel counts, per path, the month's cell edges it is not
        # below: the cell exactly where the cells do not decrease as V
        # grows, which A_t > 0 gives (with log not decreasing)
        a_host = _host_coefficients(coef_a_host, "coef_a_host", n_periods)
        if n_cells < 3 or not bool((np.isfinite(a_host) & (a_host > 0))
                                   .all()):
            raise ValueError("the band histogram needs n_bins >= 1 and "
                             "finite coef_a > 0")
        if edges is None:
            edges = hist_edges(coef_a, coef_b, n_cells - 2)
        ce._check(edges, "edges", dev, n_periods * (n_cells - 1))
        # the edges, then the running values between windows of months, one
        # a path of the chunk's 256-path warp items (overwritten)
        buf = torch.empty((edges.numel()
                           + -(-valid // _ITEM_PATHS) * _ITEM_PATHS,),
                          dtype=torch.float32, device=dev)
        buf[:edges.numel()].copy_(edges.reshape(-1))
        guess = hist_guess_coefficients(coef_a, coef_b)
    else:
        # the kernel counts, per path, the thresholds it is not below, and
        # cumulates them here: exact for thresholds that do not decrease
        # along a month's row, which B_t > 0 and ordered kk give
        b_host = _host_coefficients(coef_b_host, "coef_b_host", n_periods)
        if not (bool((b_host > 0).all())
                and kappa_lo <= 1.0 <= n_cells - 2 <= kappa_hi):
            raise ValueError("thresholds must increase along k: coef_b > 0 "
                             "and kappa_lo <= 1, kappa_hi >= K - 2")
        buf = cdf_thresholds(coef_a, coef_b, kappa_lo, kappa_hi, n_cells)
        guess = cdf_guess_coefficients(coef_a, coef_b)
    out = torch.zeros((n_periods, cells), dtype=torch.int32, device=dev)
    args = (mode, ce.DRAW_CODES[draw], ce._ptr(table), k_chunks, n_table,
            tail_n, ce._f32(a), ce._f32(b), ce._ptr(keep), ce._ptr(coef_a),
            ce._ptr(coef_b), ce._ptr(buf), ce._ptr(guess), n_periods,
            int(seed_base) & ce.MASK32, int(tile0) & ce.MASK32, valid,
            ce._f32(v0), n_cells, ce._ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    fn = load_library().smmc_bands

    def launch(buf=buf, guess=guess):  # holds them for the launch
        ce._raise_on(fn(*args), "smmc_bands")

    def counts():
        if mode == 0:
            return out
        return torch.cumsum(out[:, :n_cells], dim=1, dtype=torch.int32)

    return launch, counts


def month_hist_launcher(table, keep, coef_a, coef_b, *, n_bins, **kw):
    """``(launch, counts)`` of one band-histogram chunk (see
    ``_launcher``); ``launch()`` alone is the kernel, uncounted."""
    return _launcher(0, table, keep, coef_a, coef_b, n_cells=n_bins + 2,
                     **kw)


def month_cdf_launcher(table, keep, coef_a, coef_b, *, n_thresholds, **kw):
    """``(launch, counts)`` of one counts-below chunk (see ``_launcher``);
    ``launch()`` alone is the kernel, uncounted."""
    return _launcher(1, table, keep, coef_a, coef_b, n_cells=n_thresholds,
                     **kw)


def month_hist_chunk(table, keep, coef_a, coef_b, **kw):
    """(T, n_bins+2) int32 month histograms of one chunk, months 1..T.

    ``table``: the float32 (C*128,) padded growth table
    (``cuda_engine._pad_table``) of ``n_table`` rows for
    ``draw="historical"``, None for ``draw="gaussian"`` (growth a + b*z,
    ``cuda_engine.gaussian_ab``). ``keep``: float32 (T,) keep factors of a
    percent strategy, or None. ``coef_a``/``coef_b``: float32 (T,) bin
    coefficients A_t, B_t. Keywords: ``draw``, ``n_table``, ``a``, ``b``,
    ``n_periods``, ``seed_base`` and ``tile0`` (the uint32 stream base and
    the first global 8192-path tile), ``valid`` of the ``n_paths`` (a
    multiple of 8192) paths counting, ``v0``, ``n_bins``; on a CUDA device
    also ``coef_a_host``, a host copy of ``coef_a`` (numpy), on which A_t >
    0 is checked without a synchronisation, and optionally ``edges``, the
    coefficients' ``hist_edges`` on the device (computed once for the
    chunks of a run; else by each launch). Counts its launch under
    ``bands_hist``."""
    if coef_a.device.type == "cpu":
        return month_hist_chunk_plain(table, keep, coef_a, coef_b, **kw)
    return ce._launch_counted("bands_hist",
                              month_hist_launcher(table, keep, coef_a,
                                                  coef_b, **kw))


def month_cdf_chunk(table, keep, coef_a, coef_b, **kw):
    """(T, K) int32 counts below the K thresholds of each month of one
    chunk, months 1..T. As ``month_hist_chunk``, with ``coef_a``/``coef_b``
    the log-threshold coefficients and ``kappa_lo``, ``kappa_hi``,
    ``n_thresholds`` in place of ``n_bins``; on a CUDA device also
    ``coef_b_host``, a host copy of ``coef_b`` (numpy), on which the order
    of the thresholds is checked without a synchronisation. Counts its
    launch under ``bands_cdf``."""
    if coef_a.device.type == "cpu":
        return month_cdf_chunk_plain(table, keep, coef_a, coef_b, **kw)
    return ce._launch_counted("bands_cdf",
                              month_cdf_launcher(table, keep, coef_a,
                                                 coef_b, **kw))


def kernel_info(mode, draw, *, keep, n_table, n_periods, valid, n_cells):
    """What one band chunk launches on the current CUDA device: registers
    a thread, static and dynamic shared memory (bytes), threads a block,
    resident blocks a SM, the grid, the copies of the count table (1 for
    the histogram), the months of a window and the windows (all months in
    one for the counts below), of the kernel of ``mode`` (0 histogram of
    ``n_cells`` cells, 1 counts below ``n_cells`` thresholds), ``draw`` and
    ``keep`` (bool) for a ``valid``-path chunk and an ``n_table``-row table
    (historical)."""
    from stock_market_monte_carlo_torch.ops._build import load_library

    info = (ctypes.c_int * 9)()
    k_chunks = -(-n_table // 128) if draw == "historical" else 0
    ce._raise_on(load_library().smmc_bands_info(
        mode, ce.DRAW_CODES[draw], int(keep), k_chunks, n_periods, valid,
        n_cells, info), "smmc_bands_info")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "threads",
                     "blocks_per_sm", "grid", "copies", "window", "windows"),
                    info))


# ---------------------------------------------------------------------------
# Counts below one tile's thresholds.
# ---------------------------------------------------------------------------


def _check_tile(tl, thr):
    dev = tl.device
    ce._check(tl, "tl", dev)
    ce._check(thr, "thr", dev)
    if tl.shape != (ce.TILE_ROWS, 128) or thr.dim() != 2 \
            or thr.shape[1] != 128 or thr.shape[0] < 1:
        raise ValueError(f"tl {tuple(tl.shape)} must be ({ce.TILE_ROWS}, "
                         f"128) and thr {tuple(thr.shape)} (K, 128)")


def counts_below_tile_plain(tl, thr):
    """Plain PyTorch version of the counts-below-tile kernel: (K, 128)
    int32, out[k, c] = #{r : tl[r, c] < thr[k, c]} (strict <)."""
    _check_tile(tl, thr)
    return (tl[:, None, :] < thr[None, :, :]).sum(0).to(torch.int32)


def counts_below_tile_launcher(tl, thr):
    """Checked inputs on a CUDA device -> ``(launch, counts)``:
    ``launch()`` runs the kernel on the current stream into the (K, 128)
    int32 tensor that ``counts()`` returns; uncounted."""
    from stock_market_monte_carlo_torch.ops._build import load_library

    _check_tile(tl, thr)
    dev = tl.device
    if dev.type != "cuda":
        raise ValueError(f"no counts-below-tile kernel for device {dev}")
    out = torch.empty(thr.shape, dtype=torch.int32, device=dev)
    args = (ce._ptr(tl), ce._ptr(thr), thr.shape[0], ce._ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    fn = load_library().smmc_counts_below_tile

    def launch():
        ce._raise_on(fn(*args), "smmc_counts_below_tile")

    return launch, lambda: out


def counts_below_tile(tl, thr):
    """(K, 128) int32 counts of a tile's rows below each threshold row:
    out[k, c] = #{r : tl[r, c] < thr[k, c]}, ``tl`` float32 (64, 128),
    ``thr`` float32 (K, 128), neither sorted. The counterpart of
    ``pallas_bands._counts_below_tile`` under the test-local kernel of
    ``tests/test_bands.py``. Counts its launch under
    ``counts_below_tile``."""
    if tl.device.type == "cpu":
        return counts_below_tile_plain(tl, thr)
    return ce._launch_counted("counts_below_tile",
                              counts_below_tile_launcher(tl, thr))
