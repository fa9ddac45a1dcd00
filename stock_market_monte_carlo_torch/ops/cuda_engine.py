"""The per-chunk device work: the historical month loop and the terminal
law, each as a hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``stock_market_monte_carlo_tpu/ops/pallas_engine.py``:

- ``month_loop_chunk`` replaces ``_build_kernel`` (kind="historical",
  rng_mode="counter"), source ``csrc/month_loop.cu``;
- ``law_chunk`` replaces ``_build_law_kernel`` and
  ``_build_law_stats_kernel``, source ``csrc/terminal_law.cu``.

Each wrapper takes its plain version only for tensors that lie on the CPU.
For CUDA tensors it launches the kernel or raises; there is no fallback.
``LAUNCHES`` counts kernel launches per wrapper (plain runs do not count).

The random stream is the JAX package's arithmetic counter stream
(``SMMC_PRNG_IMPL=arith``): 32-bit integer hashing keyed by (tile seed,
draw key, position in the 8192-path tile). The helpers below compute it in
int64 tensors that hold uint32 values, masking every product to 32 bits,
because torch's ``>>`` on int32 is arithmetic and int32 overflow is not
defined behaviour there. ``_mul32`` splits each constant multiply into
16-bit halves so no intermediate leaves int64 range.

Chunk contract (same as the JAX package's chunk functions):
``stats`` float32[9] = [valid, s1, s2, s3, s4, min, max, count_below,
withdrawn] with s_k the power sums of V/v0 - shift and min/max of V/v0;
``hist`` float32[hb] with hb = n_bins + 2; ``finals`` float32[valid] when
asked for. The power sums accumulate per-path float32 terms in float64.

The histogram uses the kernel binning of ``_kernel_bin_indices`` for every
bin count (the JAX package switches to ``HistogramSpec.bin_index`` when hb
is not a multiple of 64 or exceeds 4096; the two differ only by the
underflow test at the exact lower edge).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

TILE_ROWS = 64
TILE_PATHS = TILE_ROWS * 128

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9        # == int32 -1640531527
_MIX1 = 0x85EBCA6B          # == int32 -2048144789
_MIX2 = 0xC2B2AE35          # == int32 -1028477387
_SEED_MUL = 0x6C62272E
LAW_STREAM_XOR = 0x1A37     # disjoint stream family from the month loop

_SQRT2 = float(np.float32(1.4142135623730951))
_U23 = float(2.0**-23)
_ERFINV_P0 = 2.81022636e-08
_ERFINV_P = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
             0.00021858087, -0.00125372503, -0.00417768164,
             0.246640727, 1.50140941)
_ERFINV_Q0 = -0.000200214257
_ERFINV_Q = (0.000100950558, 0.00134934322, -0.00367342844,
             0.00573950773, -0.0076224613, 0.00943887047,
             1.00167406, 2.83297682)

# Largest histogram a block holds in shared memory (48 KB of int32).
MAX_HIST_CELLS = 12288
_BLOCK = 256
_BLOCKS_PER_SM = 8

STRATEGY_CODES = {"none": 0, "fixed_percent": 1, "variable_percent": 1,
                  "fixed_amount": 2}

LAUNCHES = {"month_loop": 0, "law": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Device helpers: plain torch twins of the JAX kernel helpers. Integer
# helpers take and return int64 tensors (or Python ints) holding uint32.
# ---------------------------------------------------------------------------


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in f32 ops)."""
    return float(np.float32(x))


def _mul32(x, c: int):
    """Low 32 bits of x * c for uint32 ``x`` and a uint32 constant ``c``."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _finalize(x):
    """SplitMix-style 32-bit finalizer (the tail of both hashes)."""
    x = _mul32(x ^ (x >> 16), _MIX1)
    x = _mul32(x ^ (x >> 13), _MIX2)
    return x ^ (x >> 16)


def _tile_seed_i32(seed_base, tile):
    """Stream key of a tile: finalizer over (seed * golden) ^ tile
    (pallas_engine._tile_seed_i32)."""
    return _finalize(_mul32(seed_base, _GOLDEN) ^ tile)


def _arith_bits(seed, key, pos):
    """The word at element ``pos`` (r*128 + c in a (64,128) tile) for draw
    ``key`` of a tile seeded ``seed`` (pallas_engine._arith_bits, which
    takes the tile shape and derives pos from it)."""
    h = _tile_seed_i32(seed, key)
    return _finalize((h + _mul32(pos, _GOLDEN)) & MASK32)


def _u23_from_bits(bits):
    """Top 23 bits -> u = (cnt + 0.5) * 2^-23, strictly inside (0,1)."""
    cnt = bits >> 9
    return (cnt.to(torch.float32) + 0.5) * _U23


def _erfinv_poly(x):
    """Branch-free single-precision erfinv (pallas_engine._erfinv_poly)."""
    w = -torch.log1p(-(x * x))
    wc = w - 2.5
    p = _f32(_ERFINV_P0) * wc + _f32(_ERFINV_P[0])
    for c in _ERFINV_P[1:]:
        p = p * wc + _f32(c)
    wt = torch.sqrt(w) - 3.0
    q = _f32(_ERFINV_Q0) * wt + _f32(_ERFINV_Q[0])
    for c in _ERFINV_Q[1:]:
        q = q * wt + _f32(c)
    return torch.where(w < 5.0, p, q) * x


def _bootstrap_idx_exact_i32(st, n):
    """idx = floor(n * u32 / 2^32) via a 16-bit split (exact for
    n < 2^15). ``n`` may be a scalar or a per-lane tensor."""
    h = st >> 16
    lo = st & 0xFFFF
    return (n * h + ((n * lo) >> 16)) >> 16


def _sliced_rotation_draw(table2d, n_valid, n, tail_n, w_bits):
    """One month's sliced-rotation bootstrap draw
    (pallas_engine._sliced_rotation_draw): growth factors for words
    ``w_bits`` (..., 128), rows of 128 lanes.

    Source role of lane s: chunk c'_s = idx(w_s * n mod 2^32, n_valid[s]).
    Dest role of lane l: idx = idx(w_l, n); column w = idx if idx <
    tail_n, else the row rotation (l + (w_0 & 127)) & 127. The result is
    table2d[c'_w, w]; padding is never selected because c'_w < n_valid[w].
    """
    lane = torch.arange(128, device=w_bits.device)
    r_res = (w_bits * n) & MASK32
    cprime = _bootstrap_idx_exact_i32(r_res, n_valid)
    comb = table2d.reshape(-1)[cprime * 128 + lane]
    idx_dest = _bootstrap_idx_exact_i32(w_bits, n)
    b_row = w_bits[..., 0:1] & 127
    w_rot = (lane + b_row) & 127
    w_col = torch.where(idx_dest < tail_n, idx_dest, w_rot)
    return torch.gather(comb, -1, w_col)


def _kernel_bin_indices(values, mask, log_lo, inv_w, hb):
    """Log-space bin index (pallas_engine._kernel_bin_indices): interior
    bins clip to [1, hb-1], values with log below log_lo map to 0, masked
    paths to hb. The float is clamped before the integer cast, so huge
    values land in hb-1 as JAX's clip puts them; +inf lands there too,
    where JAX's overflowing cast puts it in cell 1."""
    logv = torch.log(torch.clamp_min(values, 1e-37))
    x = torch.floor((logv - log_lo) * inv_w)
    bins = torch.clamp(x, 0.0, float(hb - 2)).to(torch.int64) + 1
    bins = torch.where(logv < log_lo, 0, bins)
    return torch.where(mask, bins, hb)


def _pad_table(returns_pct):
    """(C*128,) float32 growth table (100 + r) * 0.01, zero padded, and
    the table length n (host numpy; pallas_engine._pad_table)."""
    r = np.asarray(returns_pct, np.float32)
    n = r.shape[0]
    c = -(-n // 128)
    flat = np.zeros((c * 128,), np.float32)
    flat[:n] = (np.float32(100.0) + r) * np.float32(0.01)
    return flat, n


def seed_base_i32(seed: int) -> np.int32:
    """Stream base of seed segment 0: ``_seed_base_i32(jax.random.key(
    seed))``. jax's default key data is [0, seed mod 2^32], so the base is
    (seed mod 2^32) * 0x6C62272E mod 2^32; no threefry is needed."""
    u = ((int(seed) & MASK32) * _SEED_MUL) & MASK32
    return np.uint32(u).view(np.int32)


# ---------------------------------------------------------------------------
# Plain chunk functions.
# ---------------------------------------------------------------------------


def _epilogue(finals, wsum, valid, v0, target, shift, log_lo, inv_w, hb,
              with_hist):
    """Stats row and histogram of one chunk's finals (first ``valid``
    paths count)."""
    inv0 = _f32(np.float32(1.0) / np.float32(v0))
    mask = torch.arange(finals.numel(), device=finals.device) < valid
    tot_s = finals * inv0
    f = torch.where(mask, tot_s - _f32(shift), 0.0)
    f2 = f * f
    inf = float("inf")
    wd = (torch.zeros((), dtype=torch.float64, device=finals.device)
          if wsum is None else torch.where(mask, wsum * inv0, 0.0).double()
          .sum())
    stats = torch.stack([
        torch.tensor(float(valid), dtype=torch.float64, device=finals.device),
        f.double().sum(), f2.double().sum(), (f2 * f).double().sum(),
        (f2 * f2).double().sum(),
        torch.where(mask, tot_s, inf).min().double(),
        torch.where(mask, tot_s, -inf).max().double(),
        (mask & (finals < _f32(target))).sum().double(),
        wd,
    ]).to(torch.float32)
    if with_hist:
        bins = _kernel_bin_indices(finals, mask, _f32(log_lo), _f32(inv_w),
                                   hb)
        hist = torch.bincount(bins, minlength=hb + 1)[:hb].to(torch.float32)
    else:
        hist = torch.zeros((hb,), dtype=torch.float32, device=finals.device)
    return stats, hist


def month_loop_chunk_plain(table, keep, *, n_table, strategy, amount,
                           n_periods, seed_base, tile0, valid, n_paths, v0,
                           target, shift, log_lo, inv_w, hb, with_hist,
                           keep_finals):
    """Plain PyTorch version of ``csrc/month_loop.cu``: the same integer
    and float32 arithmetic, vectorised over the chunk's (tiles, 64, 128)
    paths and looped over the months."""
    dev = table.device
    ntiles = n_paths // TILE_PATHS
    k_chunks = table.numel() // 128
    tail_n = n_table - 128 * (k_chunks - 1)
    table2d = table.reshape(k_chunks, 128)
    lane = torch.arange(128, device=dev)
    n_valid = torch.where(lane < tail_n, k_chunks, k_chunks - 1)
    tiles = (int(tile0) + torch.arange(ntiles, device=dev)) & MASK32
    seeds = _tile_seed_i32(int(seed_base) & MASK32, tiles)
    pos = torch.arange(TILE_PATHS, device=dev).reshape(TILE_ROWS, 128)
    pos_term = _mul32(pos, _GOLDEN)
    code = STRATEGY_CODES[strategy]
    amount = _f32(amount)

    total = torch.full((ntiles, TILE_ROWS, 128), _f32(v0),
                       dtype=torch.float32, device=dev)
    wsum = torch.zeros_like(total)
    for t in range(n_periods):
        h = _tile_seed_i32(seeds, t)[:, None, None]
        w = _finalize((h + pos_term) & MASK32)
        grown = total * _sliced_rotation_draw(table2d, n_valid, n_table,
                                              tail_n, w)
        if code == 0:
            total = grown
            continue
        if code == 1:
            new = grown * keep[t]
        else:
            new = torch.clamp_min(grown - amount, 0.0)
        wsum = wsum + (grown - new)
        total = new
    finals = total.reshape(-1)
    stats, hist = _epilogue(finals, wsum.reshape(-1), valid, v0, target,
                            shift, log_lo, inv_w, hb, with_hist)
    return stats, hist, (finals[:valid] if keep_finals else None)


def law_chunk_plain(law, *, seed_base, tile0, valid, n_paths, v0, target,
                    shift, inv_zmax, log_lo, inv_w, hb, with_hist,
                    keep_finals):
    """Plain PyTorch version of ``csrc/terminal_law.cu``: one word per
    path, u23 -> sqrt(2)*erfinv(2u-1) -> Clenshaw over the law operand
    [scale, c_0 .. c_{D-1}] -> scale * exp(...). ``seed_base`` is the law
    stream's base (already XOR-ed with LAW_STREAM_XOR)."""
    dev = law.device
    ntiles = n_paths // TILE_PATHS
    tiles = (int(tile0) + torch.arange(ntiles, device=dev)) & MASK32
    seeds = _tile_seed_i32(int(seed_base) & MASK32, tiles)[:, None]
    pos = torch.arange(TILE_PATHS, device=dev)[None, :]
    w = _arith_bits(seeds, 0, pos)
    u = _u23_from_bits(w)
    z = _SQRT2 * _erfinv_poly(2.0 * u - 1.0)
    s = z * _f32(inv_zmax)
    two_s = 2.0 * s
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for k in range(law.numel() - 2, 0, -1):
        b0 = two_s * b1 - b2 + law[1 + k]
        b2 = b1
        b1 = b0
    finals = (law[0] * torch.exp(s * b1 - b2 + law[1])).reshape(-1)
    stats, hist = _epilogue(finals, None, valid, v0, target, shift, log_lo,
                            inv_w, hb, with_hist)
    return stats, hist, (finals[:valid] if keep_finals else None)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _check(t, name, device, numel=None, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")


def _launch_geometry(device, valid, hb, with_hist):
    if with_hist and hb > MAX_HIST_CELLS:
        raise ValueError(
            f"histogram of {hb} cells exceeds the kernels' shared-memory "
            f"histogram ({MAX_HIST_CELLS} cells); use fewer histogram_bins"
        )
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-valid // _BLOCK), sms * _BLOCKS_PER_SM))


def _reduce_partials(partials, valid):
    """Per-block float64 partial rows -> the float32[9] stats row."""
    return torch.cat([
        torch.tensor([float(valid)], dtype=torch.float64,
                     device=partials.device),
        partials[:, 0:4].sum(0),
        partials[:, 4].min()[None],
        partials[:, 5].max()[None],
        partials[:, 6:8].sum(0),
    ]).to(torch.float32)


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _prepare(entry, args, dev, valid, hb, with_hist, keep_finals):
    """Allocate one chunk's outputs on ``dev`` and return ``(launch,
    outputs)``: ``launch()`` runs the C entry point ``entry`` of the kernel
    library into them on the current stream (``args`` are its leading
    arguments, before the output pointers); ``outputs()`` reduces the
    per-block partials to the (stats, hist, finals-or-None) contract."""
    from stock_market_monte_carlo_torch.ops._build import load_library

    fn = getattr(load_library(), entry)
    n_blocks = _launch_geometry(dev, valid, hb, with_hist)
    partials = torch.empty((n_blocks, 8), dtype=torch.float64, device=dev)
    hist = (torch.zeros((hb,), dtype=torch.int32, device=dev)
            if with_hist else None)
    finals = (torch.empty((valid,), dtype=torch.float32, device=dev)
              if keep_finals else None)
    tail = (_ptr(finals), _ptr(partials), _ptr(hist), n_blocks,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))

    def launch():
        _raise_on(fn(*args, *tail), entry)

    def outputs():
        stats = _reduce_partials(partials, valid)
        h = (hist.to(torch.float32) if with_hist
             else torch.zeros((hb,), dtype=torch.float32, device=dev))
        return stats, h, finals

    return launch, outputs


def _check_chunk(dev, what, valid, n_paths):
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    if n_paths % TILE_PATHS or not 0 < valid <= n_paths:
        raise ValueError(f"bad chunk: valid={valid}, n_paths={n_paths}")


def month_loop_launcher(table, keep, *, n_table, strategy, amount,
                        n_periods, seed_base, tile0, valid, n_paths, v0,
                        target, shift, log_lo, inv_w, hb, with_hist,
                        keep_finals):
    """Checked inputs of one month-loop chunk on a CUDA device ->
    ``(launch, outputs)`` (see ``_prepare``). ``launch()`` alone is the
    kernel, uncounted: ``month_loop_chunk`` is the counted entry point."""
    dev = table.device
    _check_chunk(dev, "month-loop", valid, n_paths)
    if not 0 < n_table < (1 << 15):
        raise ValueError(f"table length {n_table} outside [1, 2^15)")
    k_chunks = -(-n_table // 128)
    _check(table, "table", dev, k_chunks * 128)
    _check(keep, "keep", dev, n_periods)
    args = (_ptr(table), k_chunks, n_table, n_table - 128 * (k_chunks - 1),
            _ptr(keep), STRATEGY_CODES[strategy], _f32(amount), n_periods,
            int(seed_base) & MASK32, int(tile0) & MASK32, valid, _f32(v0),
            _f32(np.float32(1.0) / np.float32(v0)), _f32(target),
            _f32(shift), _f32(log_lo), _f32(inv_w), hb)
    return _prepare("smmc_month_loop", args, dev, valid, hb, with_hist,
                    keep_finals)


def law_launcher(law, *, seed_base, tile0, valid, n_paths, v0, target,
                 shift, inv_zmax, log_lo, inv_w, hb, with_hist, keep_finals):
    """Checked inputs of one terminal-law chunk on a CUDA device ->
    ``(launch, outputs)``, as ``month_loop_launcher``."""
    dev = law.device
    _check_chunk(dev, "terminal-law", valid, n_paths)
    _check(law, "law", dev)
    args = (_ptr(law), law.numel() - 1, int(seed_base) & MASK32,
            int(tile0) & MASK32, valid,
            _f32(np.float32(1.0) / np.float32(v0)), _f32(target),
            _f32(shift), _f32(inv_zmax), _f32(log_lo), _f32(inv_w), hb)
    return _prepare("smmc_law", args, dev, valid, hb, with_hist,
                    keep_finals)


def _launch_counted(name, launcher):
    launch, outputs = launcher
    launch()
    LAUNCHES[name] += 1
    return outputs()


def month_loop_chunk(table, keep, **kw):
    """One chunk of the historical month loop.

    ``table``: float32 (C*128,) padded growth table (``_pad_table``);
    ``keep``: float32 (n_periods,) keep factors (read by the percent
    strategies); keywords as ``month_loop_chunk_plain``, with
    ``seed_base``/``tile0`` the uint32 stream base and first global tile
    and ``valid`` of the ``n_paths`` (a multiple of 8192) paths counting.
    Returns (stats, hist, finals-or-None) on ``table.device``."""
    if table.device.type == "cpu":
        return month_loop_chunk_plain(table, keep, **kw)
    return _launch_counted("month_loop",
                           month_loop_launcher(table, keep, **kw))


def law_chunk(law, **kw):
    """One chunk of the terminal-law sampler. ``law``: float32
    (LAW_OP_LEN,) operand [scale, c_0 .. c_{D-1}]; keywords as
    ``law_chunk_plain`` (``seed_base`` is the law stream's base). Same
    outputs as ``month_loop_chunk`` (withdrawn row 0)."""
    if law.device.type == "cpu":
        return law_chunk_plain(law, **kw)
    return _launch_counted("law", law_launcher(law, **kw))
