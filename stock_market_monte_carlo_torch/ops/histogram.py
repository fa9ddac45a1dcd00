"""The histogram kernel in its three binning modes, and the tile flatten,
as hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of the histogram probes of ``experiments/`` and of the JAX
package's XLA histogram epilogue:

- ``histogram_counts(..., mode="index")`` replaces
  ``experiments/exp_pallas_hist.py:hist_kernel`` (``pl.pallas_call`` at
  :40, (4096,1) column tiles) and ``experiments/exp_rowhist.py:
  hist_kernel`` (:40, (64,128) row tiles): counts of int32 bin indices;
  an index outside [0, hb) is dropped (hb is a masked lane's index);
- ``mode="clip_cast"`` replaces ``experiments/exp_flatten_cost.py:k_hist``
  (:65): float32 values cast to int32 (toward zero), then clipped to
  [0, hb-1];
- ``mode="spec"`` replaces the epilogue of ``stock_market_monte_carlo_tpu/
  ops/pallas_engine.py`` (:1753-1758), ``HistogramSpec.bin_index`` then
  ``histogram_counts``: the engine's histogram of a chunk's finals when the
  chunk kernels cannot bin in place (``cuda_engine.in_kernel_hist``);
- ``flatten_tile`` replaces ``exp_flatten_cost.py:k_reshape`` (:29): (64,128)
  tiles to one (8192,1) column in row-major order.

Source ``csrc/histogram.cu``. The plain versions count as the experiments
do: per tile of ``TILE`` inputs, the factorised one-hot product
``(hi == h)^T @ (lo == k)`` with ``hi = idx >> 6``, ``lo = idx & 63``,
exact in float32 (a tile's cell holds at most ``TILE``), the tiles summed
in int64. ``torch.bincount`` computes the same counts in one call; it is a
yardstick of time (``library_counts``), never the plain version.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. Launches count under
``cuda_engine.LAUNCHES[COUNTERS[mode]]`` and ``["flatten_tile"]``.
"""

from __future__ import annotations

import ctypes

import torch

from stock_market_monte_carlo_torch.ops import cuda_engine as ce

MODES = {"index": 0, "clip_cast": 1, "spec": 2}
# the launch counter of each mode; "histogram" is the engine's route
COUNTERS = {"spec": "histogram", "index": "histogram_index",
            "clip_cast": "histogram_clip_cast"}
TILE = ce.TILE_PATHS
_LO_CELLS = 64
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
# one-hot elements of a batch of tiles in the plain count (128 MiB float32)
_ONE_HOT_BATCH = 1 << 25


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _int32_cast(x):
    """int64 values of XLA's and CUDA's float -> int32 cast of ``x``
    (toward zero, saturating, NaN to 0)."""
    c = torch.where(torch.isnan(x), 0.0,
                    x.double().clamp(_INT32_MIN, _INT32_MAX))
    return c.to(torch.int64)


def spec_bin_indices(values, *, lo, log_lo, inv_w, n_bins):
    """``HistogramSpec.bin_index`` of the JAX package
    (``ops/reductions.py``) as XLA on the CPU runs it, as int64: the log of
    max(v, 1e-37) (NaN kept), floor((logv - log_lo) * inv_w) cast to int32,
    + 1 with int32 wrap-around (so +inf lands in cell 1), clipped to
    [1, n_bins + 1]; 0 where v < lo in value space. Scalars round to
    float32 as JAX's weakly typed Python floats do."""
    v = values.to(torch.float32)
    logv = torch.log(torch.clamp_min(v, 1e-37))
    x = torch.floor((logv - ce._f32(log_lo)) * ce._f32(inv_w))
    raw = _int32_cast(x) + 1
    raw = torch.where(raw > _INT32_MAX, raw - (1 << 32), raw)
    idx = torch.clamp(raw, 1, n_bins + 1)
    return torch.where(v < ce._f32(lo), 0, idx)


def clip_cast_indices(x, hb):
    """``clip(x.astype(int32), 0, hb - 1)`` as int64 (the cast as
    ``_int32_cast``)."""
    return torch.clamp(_int32_cast(x.to(torch.float32)), 0, hb - 1)


def count_plain(idx, hb):
    """int32 (hb,) counts of the indices ``idx`` (any integer tensor),
    those outside [0, hb) dropped: the factorised one-hot product per tile
    of ``TILE`` indices (exact in float32), summed over tiles in int64."""
    dev = idx.device
    flat = idx.reshape(-1).to(torch.int64)
    n_tiles = -(-flat.numel() // TILE)
    pad = torch.full((n_tiles * TILE - flat.numel(),), -1, dtype=torch.int64,
                     device=dev)
    tiles = torch.cat([flat, pad]).reshape(n_tiles, TILE)
    n_hi = -(-hb // _LO_CELLS)
    his = torch.arange(n_hi, device=dev)
    los = torch.arange(_LO_CELLS, device=dev)
    counts = torch.zeros((n_hi, _LO_CELLS), dtype=torch.int64, device=dev)
    batch = max(1, _ONE_HOT_BATCH // (TILE * n_hi))
    for t0 in range(0, n_tiles, batch):
        t = tiles[t0:t0 + batch]
        oh_hi = ((t >> 6)[..., None] == his).to(torch.float32)
        oh_lo = ((t & 63)[..., None] == los).to(torch.float32)
        per_tile = torch.bmm(oh_hi.transpose(1, 2), oh_lo)
        counts += per_tile.to(torch.int64).sum(0)
    return counts.reshape(-1)[:hb].to(torch.int32)


def histogram_plain(x, hb, *, mode="index", lo=None, log_lo=None,
                    inv_w=None):
    """Plain PyTorch version of ``csrc/histogram.cu``: the mode's bins of
    ``x`` (``_check_inputs``), then ``count_plain``."""
    _check_inputs(x, hb, mode, lo, log_lo, inv_w)
    if mode == "index":
        idx = x
    elif mode == "clip_cast":
        idx = clip_cast_indices(x, hb)
    else:
        idx = spec_bin_indices(x, lo=lo, log_lo=log_lo, inv_w=inv_w,
                               n_bins=hb - 2)
    return count_plain(idx, hb)


def flatten_tile_plain(x):
    """(n_tiles*8192, 1) float32: the (64,128) tiles of ``x`` in
    row-major order, a new tensor."""
    _check_tiles(x)
    return x.reshape(-1, 1).clone()


def library_counts(idx, hb):
    """``torch.bincount`` of int32 indices in [0, hb]: the one PyTorch call
    that computes mode "index"'s counts, timed beside the kernel."""
    return torch.bincount(idx.reshape(-1), minlength=hb + 1)[:hb]


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check_inputs(x, hb, mode, lo, log_lo, inv_w):
    if mode not in MODES:
        raise ValueError(f"unknown histogram mode {mode!r}")
    want = torch.int32 if mode == "index" else torch.float32
    if x.dtype != want:
        raise TypeError(f"mode {mode!r} counts {want}, got {x.dtype}")
    if not 0 <= x.numel() <= _INT32_MAX:
        raise ValueError(f"{x.numel()} inputs exceed the kernel's int32 "
                         "count")
    if hb < (3 if mode == "spec" else 1):
        raise ValueError(f"bad histogram of {hb} cells for mode {mode!r}")
    if mode == "spec" and None in (lo, log_lo, inv_w):
        raise ValueError("mode 'spec' needs lo, log_lo and inv_w")


def histogram_launcher(x, hb, *, mode="index", lo=None, log_lo=None,
                       inv_w=None):
    """Checked inputs of one histogram on a CUDA device -> ``(launch,
    outputs)``: ``launch()`` runs the kernel on the current stream,
    uncounted; ``outputs()`` returns the int32 (hb,) counts."""
    from stock_market_monte_carlo_torch.ops._build import load_library

    _check_inputs(x, hb, mode, lo, log_lo, inv_w)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no histogram kernel for device {dev}")
    if not x.is_contiguous():
        raise ValueError("the histogram's input must be contiguous")
    hist = torch.zeros((hb,), dtype=torch.int32, device=dev)
    spec = ((ce._f32(lo), ce._f32(log_lo), ce._f32(inv_w))
            if mode == "spec" else (0.0, 0.0, 0.0))
    args = (MODES[mode], ce._ptr(x), x.numel(), hb, *spec, ce._ptr(hist),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    fn = load_library().smmc_histogram

    def launch(held=(hist,)):  # for the kernel
        ce._raise_on(fn(*args), "smmc_histogram")

    return launch, lambda: hist


def histogram_counts(x, hb, *, mode="index", lo=None, log_lo=None,
                     inv_w=None):
    """int32 (hb,) counts of the bins of ``x`` on ``x.device``.

    ``mode="index"``: ``x`` int32 bin indices. ``"clip_cast"``: ``x``
    float32, binned as ``clip(int32(x), 0, hb - 1)``. ``"spec"``: ``x``
    float32 finals, binned by ``HistogramSpec.bin_index`` of the spec with
    ``lo``, ``log_lo`` = log(lo), ``inv_w`` = 1/width and n_bins = hb - 2
    (``spec_bin_indices``). A bin outside [0, hb) is dropped. Counts its
    launch under ``COUNTERS[mode]``."""
    if x.device.type == "cpu":
        return histogram_plain(x, hb, mode=mode, lo=lo, log_lo=log_lo,
                               inv_w=inv_w)
    return ce._launch_counted(COUNTERS[mode], histogram_launcher(
        x, hb, mode=mode, lo=lo, log_lo=log_lo, inv_w=inv_w))


def _check_tiles(x):
    if x.dtype != torch.float32:
        raise TypeError(f"flatten_tile takes float32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != 128 or x.numel() % TILE:
        raise ValueError(f"flatten_tile takes (64,128) tiles, got shape "
                         f"{tuple(x.shape)}")


def flatten_tile_launcher(x):
    """Checked input of one flatten on a CUDA device -> ``(launch,
    outputs)``, as ``histogram_launcher``."""
    from stock_market_monte_carlo_torch.ops._build import load_library

    _check_tiles(x)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no flatten kernel for device {dev}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("flatten_tile's input must be contiguous and "
                         "16-byte aligned")
    out = torch.empty((x.numel(), 1), dtype=torch.float32, device=dev)
    args = (ce._ptr(x), ce._ptr(out), x.numel() // TILE,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    fn = load_library().smmc_flatten_tile

    def launch(held=(out,)):  # for the kernel
        ce._raise_on(fn(*args), "smmc_flatten_tile")

    return launch, lambda: out


def flatten_tile(x):
    """The (64,128) float32 tiles of ``x`` (last dimension 128, a multiple
    of 8192 elements) as one (n_tiles*8192, 1) column in row-major order,
    on ``x.device``. Counts its launch under ``flatten_tile``."""
    if x.device.type == "cpu":
        return flatten_tile_plain(x)
    return ce._launch_counted("flatten_tile", flatten_tile_launcher(x))
