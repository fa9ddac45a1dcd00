"""The per-chunk device work: the month loop and the terminal law, each
as a hand-written CUDA kernel and its plain PyTorch version. The CLT
sampler is ``ops/clt.py``.

Counterpart of ``stock_market_monte_carlo_tpu/ops/pallas_engine.py``:

- ``month_loop_chunk`` replaces ``_build_kernel``, source
  ``csrc/month_loop.cu``, in five draws (``DRAW_CODES``): the counter
  stream's historical bootstrap and Gaussian ICDF, the Sobol Gaussian and
  Sobol historical draws (32-bit or 64-bit sequence positions) and the
  reference-parity historical stream;
- ``law_chunk`` replaces ``_build_law_kernel`` and
  ``_build_law_stats_kernel``, source ``csrc/terminal_law.cu``.

Each wrapper takes its plain version only for tensors that lie on the CPU.
For CUDA tensors it launches the kernel or raises; there is no fallback.
``LAUNCHES`` counts kernel launches per kernel (plain runs do not count):
the month loop's draws (``MONTH_LOOP_COUNTERS``), ``law``, ``clt``
(``ops/clt.py``), ``bands_hist``, ``bands_cdf`` and ``counts_below_tile``
(``ops/bands.py``), ``grid_overhead`` and ``calib``
(``ops/calibration.py``), ``histogram``, ``histogram_index``,
``histogram_clip_cast`` and ``flatten_tile`` (``ops/histogram.py``),
``op_toy_<op>`` (``ops/calibration.py``), ``clt_probe_<ablate>`` and
``clt_probe_ts<TS>`` (``ops/clt.py``) and ``byte_planes``
(``ops/byte_planes.py``).

The default random stream is the JAX package's arithmetic counter stream
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

The histogram follows the JAX package's rule (``in_kernel_hist``): when
hb is a multiple of 64 and at most 4096, the chunk kernel bins each final
in place (``_kernel_bin_indices``); otherwise the kernel writes the finals
and the histogram kernel counts them as ``HistogramSpec.bin_index`` bins
them (``ops/histogram.py``, mode ``"spec"``), as the JAX package's XLA
epilogue does. The two binnings differ only at the exact lower edge (the
underflow test is ``logv < log_lo`` in the kernel, ``v < lo`` in the
spec) and for +inf (cell hb-1 against cell 1).
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

# Largest histogram the chunk kernels bin in place (the JAX package's
# 64x64 MXU histogram); larger or odd ones go to the histogram kernel.
KERNEL_HIST_CELLS = 4096
_BLOCK = 256
_BLOCKS_PER_SM = 8

STRATEGY_CODES = {"none": 0, "fixed_percent": 1, "variable_percent": 1,
                  "fixed_amount": 2}
DRAW_CODES = {"historical": 0, "gaussian": 1, "sobol_gaussian": 2,
              "sobol_historical": 3, "reference": 4}
# the month loop's launch counter of each draw
MONTH_LOOP_COUNTERS = {
    "historical": "month_loop",
    "gaussian": "month_loop_gaussian",
    "sobol_gaussian": "month_loop_sobol_gaussian",
    "sobol_historical": "month_loop_sobol_historical",
    "reference": "month_loop_reference",
}
_TABLE_DRAWS = ("historical", "sobol_historical", "reference")
_SOBOL_DRAWS = ("sobol_gaussian", "sobol_historical")

LAUNCHES = dict.fromkeys(
    [*MONTH_LOOP_COUNTERS.values(), "law", "clt", "bands_hist",
     "bands_cdf", "counts_below_tile", "grid_overhead", "calib",
     "histogram", "histogram_index", "histogram_clip_cast", "flatten_tile",
     *(f"op_toy_{op}" for op in ("mul", "fma", "iadd", "shf", "cvt", "mm",
                                 "hash")),
     *(f"clt_probe_{a}" for a in ("base", "nohist", "nologexp", "nodraw",
                                  "nomm")),
     *(f"clt_probe_ts{t}" for t in (1, 2, 4)),
     "byte_planes"],
    0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def in_kernel_hist(hb: int, with_hist: bool) -> bool:
    """Whether a chunk kernel bins its finals in place: the JAX package's
    ``mxu_hist = with_hist and hb % 64 == 0 and hb <= 4096``
    (``pallas_engine.py``). Otherwise, with a histogram, the finals go
    through the histogram kernel in mode ``"spec"``."""
    return with_hist and hb % 64 == 0 and hb <= KERNEL_HIST_CELLS


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


def _pcg_hash_i32(x):
    """The reference simulator's rand_pcg as a hash of ``x``
    (pallas_engine._pcg_hash_i32)."""
    word = _mul32((x >> ((x >> 28) + 4)) ^ x, 277803737)
    return (word >> 22) ^ word


def _xorshift_i32(y):
    """One 11/7/12 xorshift step (pallas_engine._xorshift_i32)."""
    y = y ^ ((y << 11) & MASK32)
    y = y ^ (y >> 7)
    return y ^ (y >> 12)


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


def _normal_z(bits):
    """z = sqrt(2) * erfinv(2u - 1) of a word (the Gaussian draw)."""
    return _SQRT2 * _erfinv_poly(2.0 * _u23_from_bits(bits) - 1.0)


def gaussian_ab(mean_pct, std_pct):
    """Growth constants of a Gaussian model, growth = a + b*z, rounded in
    float32 as ``pallas_chunk_stats`` builds them: a = 1 + mean*0.01,
    b = std*0.01."""
    f32 = np.float32
    return (float(f32(1.0) + f32(mean_pct) * f32(0.01)),
            float(f32(std_pct) * f32(0.01)))


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


def key_seed_base(k0: int, k1: int) -> int:
    """uint32 stream base of a threefry key with data (k0, k1):
    ``pallas_engine._seed_base_i32``, k0 ^ (k1 * 0x6C62272E) mod 2^32."""
    return (k0 ^ (k1 * _SEED_MUL)) & MASK32


def _as_u32(x, device=None) -> torch.Tensor:
    """uint32 values of ``x`` (numpy, a tensor of uint32 values or of
    their int32 bits, or an int) as an int64 tensor."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64) & MASK32
    return torch.as_tensor(np.asarray(x, np.uint32).astype(np.int64),
                           device=device)


def _as_i32(words, device):
    """uint32 words (an int64 tensor of uint32 values or a numpy array)
    as an int32 tensor of the same bits on ``device``."""
    if torch.is_tensor(words):
        words = words.cpu().numpy()
    return torch.as_tensor(np.asarray(words, np.int64).astype(np.uint32)
                           .view(np.int32), device=device)


def model_draw(model) -> str:
    """The month-loop draw of a model: its ``kind``, or ``"reference"``
    for a historical model on the reference-parity stream."""
    if getattr(model, "rng", "counter") == "reference":
        return "reference"
    return model.kind


def draw_operands(model, device, n_periods=None, sobol_shift=None):
    """(table, draw keywords) of the month-loop and band kernels for
    ``model`` on ``device``: the padded growth table and its length
    (historical kinds) or None and the growth constants a, b (Gaussian
    kinds); for the Sobol kinds also ``direction``, the model's first
    ``n_periods`` rows of direction numbers as an int32 (n_periods, 32|64)
    tensor of uint32 bits, ``sobol_shift``, the run's (n_periods,) digital
    shift (``sobol.digital_shift``), likewise, and ``index_offset``."""
    draw = model_draw(model)
    kw = dict(draw=draw, n_table=0, a=0.0, b=0.0)
    table = None
    if draw in _TABLE_DRAWS:
        table_np, kw["n_table"] = _pad_table(model.returns_pct)
        table = torch.as_tensor(table_np, device=device)
    else:
        kw["a"], kw["b"] = gaussian_ab(model.mean_pct, model.std_pct)
    if draw in _SOBOL_DRAWS:
        direction = np.asarray(model.direction, np.uint32)[:n_periods]
        kw.update(
            direction=torch.tensor(direction.view(np.int32),
                                   device=device),
            sobol_shift=_as_i32(sobol_shift, device),
            index_offset=int(model.index_offset))
    return table, kw


# ---------------------------------------------------------------------------
# Plain chunk functions.
# ---------------------------------------------------------------------------


def _epilogue(finals, wsum, valid, v0, target, shift, lo, log_lo, inv_w, hb,
              with_hist, stats_dtype=torch.float32):
    """Stats row and histogram of one chunk's finals (first ``valid``
    paths count), the histogram binned as the chunk's route bins it
    (``in_kernel_hist``). The stats row is float32 unless ``stats_dtype``
    keeps the float64 sums."""
    from stock_market_monte_carlo_torch.ops import histogram

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
        torch.full((), float(valid), dtype=torch.float64,
                   device=finals.device),
        f.double().sum(), f2.double().sum(), (f2 * f).double().sum(),
        (f2 * f2).double().sum(),
        torch.where(mask, tot_s, inf).min().double(),
        torch.where(mask, tot_s, -inf).max().double(),
        (mask & (finals < _f32(target))).sum().double(),
        wd,
    ]).to(stats_dtype)
    if in_kernel_hist(hb, with_hist):
        bins = _kernel_bin_indices(finals, mask, _f32(log_lo), _f32(inv_w),
                                   hb)
        hist = torch.bincount(bins, minlength=hb + 1)[:hb].to(torch.float32)
    elif with_hist:
        hist = histogram.histogram_plain(
            finals[:valid], hb, mode="spec", lo=lo, log_lo=log_lo,
            inv_w=inv_w).to(torch.float32)
    else:
        hist = torch.zeros((hb,), dtype=torch.float32, device=finals.device)
    return stats, hist


def _xor_tables(direction):
    """(dims, cols/8, 256) byte tables of a (dims, cols) table of uint32
    direction numbers: entry [d, k, v] is the XOR of direction[d, 8k + j]
    over the set bits j of v. The Sobol fold then runs a byte of the gray
    code at a time, one gathered entry per byte; XOR makes it the
    kernels' bit-by-bit fold exactly."""
    d = _as_u32(direction)
    dims, cols = d.shape
    v = torch.arange(256, device=d.device)
    d8 = d.reshape(dims, cols // 8, 8)
    tab = torch.zeros((dims, cols // 8, 256), dtype=torch.int64,
                      device=d.device)
    for j in range(8):
        tab = tab ^ torch.where(((v >> j) & 1).bool(), d8[:, :, j, None], 0)
    return tab


def _bytes(gray, n_bytes):
    """The low ``n_bytes`` bytes of the 64-bit patterns in ``gray``."""
    return [(gray >> (8 * k)) & 255 for k in range(n_bytes)]


def xor_fold(direction, gray):
    """(..., dims) unshifted Sobol words of the gray codes ``gray`` (...,):
    the XOR of direction[d, b] over the set bits b of each code."""
    tab = _xor_tables(direction)
    gbytes = _bytes(gray, tab.shape[1])
    acc = tab[:, 0][:, gbytes[0]]
    for k in range(1, len(gbytes)):
        acc = acc ^ tab[:, k][:, gbytes[k]]
    return acc.movedim(0, -1)


def _sobol_words(direction, shift, index_offset, gid):
    """``word(t)``: the digital-shifted Sobol words of dimension t at
    sequence positions index_offset + ``gid`` (int64 tensor of uint32),
    from the byte tables of every month at once."""
    tab = _xor_tables(direction)
    idx = int(index_offset) + gid
    gbytes = _bytes(idx ^ (idx >> 1), tab.shape[1])
    shift = _as_u32(shift)

    def word(t):
        acc = shift[t]
        for k, byte in enumerate(gbytes):
            acc = acc ^ tab[t, k][byte]
        return acc
    return word


def month_growth(dev, table, *, draw, n_table, a, b, seed_base, tile0,
                 n_paths, direction=None, shift=None, index_offset=0):
    """``growth(t)``: the (tiles, 64, 128) float32 growth factors of month
    t of a chunk's paths on ``dev``, the plain month loop's and band
    kernels' draw. Counter draws take one word per path and month from the
    arithmetic stream, keyed by the tile and the month:
    ``draw="historical"`` reads ``table`` (``n_table`` rows) by the
    sliced-rotation bootstrap; ``draw="gaussian"`` grows by a + b*z and
    takes ``table=None``. The Sobol draws take the word of dimension t at
    the path's sequence position (``direction``, ``shift``,
    ``index_offset``), to a + b*z or to table row floor(n * word / 2^32);
    ``draw="reference"`` steps each path's xorshift state (call ``growth``
    for t = 0, 1, ... in order) to table row floor(n * state / 2^32)."""
    if draw in _SOBOL_DRAWS or draw == "reference":
        gid = ((int(tile0) * TILE_PATHS
                + torch.arange(n_paths, dtype=torch.int64, device=dev))
               & MASK32).reshape(-1, TILE_ROWS, 128)
        if draw == "sobol_gaussian":
            a, b = _f32(a), _f32(b)
            word = _sobol_words(direction, shift, index_offset, gid)
            return lambda t: a + b * _normal_z(word(t))
        if draw == "sobol_historical":
            word = _sobol_words(direction, shift, index_offset, gid)
            return lambda t: table[_bootstrap_idx_exact_i32(word(t),
                                                            n_table)]
        state = [_pcg_hash_i32((gid + 1) & MASK32), 0]

        def growth(t):
            if t != state[1]:
                raise ValueError("the reference stream steps month by "
                                 f"month: month {t} after {state[1]}")
            state[0] = _xorshift_i32(state[0])
            state[1] += 1
            return table[_bootstrap_idx_exact_i32(state[0], n_table)]
        return growth
    if draw == "historical":
        k_chunks = table.numel() // 128
        tail_n = n_table - 128 * (k_chunks - 1)
        table2d = table.reshape(k_chunks, 128)
        lane = torch.arange(128, device=dev)
        n_valid = torch.where(lane < tail_n, k_chunks, k_chunks - 1)

        def draw_fn(w):
            return _sliced_rotation_draw(table2d, n_valid, n_table, tail_n, w)
    elif draw == "gaussian":
        a, b = _f32(a), _f32(b)

        def draw_fn(w):
            return a + b * _normal_z(w)
    else:
        raise ValueError(f"unknown draw {draw!r}")
    tiles = (int(tile0) + torch.arange(n_paths // TILE_PATHS, device=dev)
             ) & MASK32
    seeds = _tile_seed_i32(int(seed_base) & MASK32, tiles)
    pos = torch.arange(TILE_PATHS, device=dev).reshape(TILE_ROWS, 128)
    pos_term = _mul32(pos, _GOLDEN)

    def growth(t):
        h = _tile_seed_i32(seeds, t)[:, None, None]
        return draw_fn(_finalize((h + pos_term) & MASK32))
    return growth


def month_loop_chunk_plain(table, keep, *, strategy, amount, n_periods,
                           seed_base, tile0, valid, n_paths, v0, target,
                           shift, lo, log_lo, inv_w, hb, with_hist,
                           keep_finals, draw="historical", n_table=0, a=0.0,
                           b=0.0, direction=None, sobol_shift=None,
                           index_offset=0):
    """Plain PyTorch version of ``csrc/month_loop.cu``: the same integer
    and float32 arithmetic, vectorised over the chunk's (tiles, 64, 128)
    paths and looped over the months; the draw as ``month_growth``
    (``sobol_shift`` is its ``shift``; ``shift`` is the moments' centre)."""
    dev = keep.device
    growth = month_growth(dev, table, draw=draw, n_table=n_table, a=a, b=b,
                          seed_base=seed_base, tile0=tile0, n_paths=n_paths,
                          direction=direction, shift=sobol_shift,
                          index_offset=index_offset)
    code = STRATEGY_CODES[strategy]
    amount = _f32(amount)

    total = torch.full((n_paths // TILE_PATHS, TILE_ROWS, 128), _f32(v0),
                       dtype=torch.float32, device=dev)
    wsum = torch.zeros_like(total)
    for t in range(n_periods):
        grown = total * growth(t)
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
                            shift, lo, log_lo, inv_w, hb, with_hist)
    return stats, hist, (finals[:valid] if keep_finals else None)


def law_chunk_plain(law, *, seed_base, tile0, valid, n_paths, v0, target,
                    shift, inv_zmax, lo, log_lo, inv_w, hb, with_hist,
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
    s = _normal_z(_arith_bits(seeds, 0, pos)) * _f32(inv_zmax)
    two_s = 2.0 * s
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for k in range(law.numel() - 2, 0, -1):
        b0 = two_s * b1 - b2 + law[1 + k]
        b2 = b1
        b1 = b0
    finals = (law[0] * torch.exp(s * b1 - b2 + law[1])).reshape(-1)
    stats, hist = _epilogue(finals, None, valid, v0, target, shift, lo,
                            log_lo, inv_w, hb, with_hist)
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


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_geometry(sms, valid, rows_per_block, blocks_per_sm):
    """Blocks of a chunk's grid on a card of ``sms`` SMs: enough to cover
    ``valid`` paths at ``rows_per_block`` a block, at most
    ``blocks_per_sm`` a SM (the blocks stride)."""
    return max(1, min(-(-valid // rows_per_block), sms * blocks_per_sm))


def _reduce_partials(partials, valid, stats_dtype=torch.float32):
    """Per-block float64 partial rows -> the float32[9] stats row (or
    float64, with ``stats_dtype``). The path count is filled on the device:
    a tensor made from a host value would be a copy that waits for the
    stream."""
    return torch.cat([
        torch.full((1,), float(valid), dtype=torch.float64,
                   device=partials.device),
        partials[:, 0:4].sum(0),
        partials[:, 4].min()[None],
        partials[:, 5].max()[None],
        partials[:, 6:8].sum(0),
    ]).to(stats_dtype)


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _prepare(entry, args, dev, valid, *, lo, log_lo, inv_w, hb, with_hist,
             keep_finals, rows_per_block=_BLOCK,
             blocks_per_sm=_BLOCKS_PER_SM, n_blocks=None,
             stats_dtype=torch.float32):
    """Allocate one chunk's outputs on ``dev`` and return ``(launch,
    outputs)``: ``launch()`` runs the C entry point ``entry`` of the kernel
    library into them on the current stream (``args`` are its leading
    arguments, before the output pointers); ``outputs()`` reduces the
    per-block partials to the (stats, hist, finals-or-None) contract. The
    grid covers ``valid`` paths at ``rows_per_block`` paths per block, at
    most ``blocks_per_sm`` blocks per SM (the blocks stride), unless the
    caller fixes ``n_blocks``; ``stats_dtype`` as ``_reduce_partials``.
    Where the kernel cannot bin in place (``in_kernel_hist``), it writes the
    finals and ``outputs()`` counts them with the histogram kernel (counted
    under ``histogram``)."""
    from stock_market_monte_carlo_torch.ops import histogram
    from stock_market_monte_carlo_torch.ops._build import load_library

    fn = getattr(load_library(), entry)
    if n_blocks is None:
        n_blocks = _launch_geometry(_sm_count(dev), valid, rows_per_block,
                                    blocks_per_sm)
    binned = in_kernel_hist(hb, with_hist)
    spec_route = with_hist and not binned
    partials = torch.empty((n_blocks, 8), dtype=torch.float64, device=dev)
    hist = (torch.zeros((hb,), dtype=torch.int32, device=dev)
            if binned else None)
    finals = (torch.empty((valid,), dtype=torch.float32, device=dev)
              if keep_finals or spec_route else None)
    tail = (_ptr(finals), _ptr(partials), _ptr(hist), n_blocks,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))

    def launch():
        _raise_on(fn(*args, *tail), entry)

    def outputs():
        stats = _reduce_partials(partials, valid, stats_dtype)
        if binned:
            h = hist.to(torch.float32)
        elif spec_route:
            h = histogram.histogram_counts(
                finals, hb, mode="spec", lo=lo, log_lo=log_lo,
                inv_w=inv_w).to(torch.float32)
        else:
            h = torch.zeros((hb,), dtype=torch.float32, device=dev)
        return stats, h, (finals if keep_finals else None)

    return launch, outputs


def _check_chunk(dev, what, valid, n_paths):
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    if n_paths % TILE_PATHS or not 0 < valid <= n_paths:
        raise ValueError(f"bad chunk: valid={valid}, n_paths={n_paths}")


def month_loop_launcher(table, keep, *, strategy, amount, n_periods,
                        seed_base, tile0, valid, n_paths, v0, target, shift,
                        lo, log_lo, inv_w, hb, with_hist, keep_finals,
                        draw="historical", n_table=0, a=0.0, b=0.0,
                        direction=None, sobol_shift=None, index_offset=0):
    """Checked inputs of one month-loop chunk on a CUDA device ->
    ``(launch, outputs)`` (see ``_prepare``). ``launch()`` alone is the
    kernel, uncounted: ``month_loop_chunk`` is the counted entry point."""
    dev = keep.device
    _check_chunk(dev, "month-loop", valid, n_paths)
    _check(keep, "keep", dev, n_periods)
    if draw not in DRAW_CODES:
        raise ValueError(f"unknown draw {draw!r}")
    # what the kernel keeps in shared memory always fits a block: the table
    # (at most 2^15 rows, 128 KB) and an in-place histogram (at most 4096
    # cells); the Sobol direction rows sit there only where they fit too
    # (csrc/month_loop.cu reads them from global memory otherwise)
    if draw in _TABLE_DRAWS:
        if not 0 < n_table < (1 << 15):
            raise ValueError(f"table length {n_table} outside [1, 2^15)")
        k_chunks = -(-n_table // 128)
        _check(table, "table", dev, k_chunks * 128)
        tail_n = n_table - 128 * (k_chunks - 1)
    else:
        if table is not None:
            raise ValueError(f"the {draw} draw takes no table")
        k_chunks = tail_n = n_table = 0
    dir_cols = 0
    if draw in _SOBOL_DRAWS:
        if direction is None or sobol_shift is None:
            raise ValueError(f"the {draw} draw needs direction and "
                             "sobol_shift")
        _check(direction, "direction", dev, dtype=torch.int32)
        dir_cols = direction.shape[-1]
        if direction.shape != (n_periods, dir_cols) or dir_cols not in (32,
                                                                         64):
            raise ValueError(
                f"direction has shape {tuple(direction.shape)}, expected "
                f"({n_periods}, 32) or ({n_periods}, 64)")
        _check(sobol_shift, "sobol_shift", dev, n_periods, torch.int32)
        if not 0 <= index_offset < (1 << 62):
            raise ValueError(f"index_offset {index_offset} outside [0, 2^62)")
        if index_offset and dir_cols != 64:
            raise ValueError("a nonzero index_offset needs the (n_periods, "
                             "64) direction table")
    elif direction is not None or sobol_shift is not None:
        raise ValueError(f"the {draw} draw takes no Sobol operands")
    args = (DRAW_CODES[draw], _ptr(table), k_chunks, n_table, tail_n,
            _f32(a), _f32(b), _ptr(direction), _ptr(sobol_shift), dir_cols,
            index_offset & MASK32, index_offset >> 32, _ptr(keep),
            STRATEGY_CODES[strategy], _f32(amount), n_periods,
            int(seed_base) & MASK32, int(tile0) & MASK32, valid, _f32(v0),
            _f32(np.float32(1.0) / np.float32(v0)), _f32(target),
            _f32(shift), _f32(log_lo), _f32(inv_w), hb)
    return _prepare("smmc_month_loop", args, dev, valid, lo=lo,
                    log_lo=log_lo, inv_w=inv_w, hb=hb, with_hist=with_hist,
                    keep_finals=keep_finals)


def law_launcher(law, *, seed_base, tile0, valid, n_paths, v0, target,
                 shift, inv_zmax, lo, log_lo, inv_w, hb, with_hist,
                 keep_finals):
    """Checked inputs of one terminal-law chunk on a CUDA device ->
    ``(launch, outputs)``, as ``month_loop_launcher``."""
    dev = law.device
    _check_chunk(dev, "terminal-law", valid, n_paths)
    _check(law, "law", dev)
    args = (_ptr(law), law.numel() - 1, int(seed_base) & MASK32,
            int(tile0) & MASK32, valid,
            _f32(np.float32(1.0) / np.float32(v0)), _f32(target),
            _f32(shift), _f32(inv_zmax), _f32(log_lo), _f32(inv_w), hb)
    return _prepare("smmc_law", args, dev, valid, lo=lo, log_lo=log_lo,
                    inv_w=inv_w, hb=hb, with_hist=with_hist,
                    keep_finals=keep_finals)


def _launch_counted(name, launcher):
    launch, outputs = launcher
    launch()
    LAUNCHES[name] += 1
    return outputs()


def month_loop_chunk(table, keep, **kw):
    """One chunk of the month loop.

    ``draw="historical"`` (the default), ``"sobol_historical"`` and
    ``"reference"``: ``table`` is the float32 (C*128,) padded growth table
    (``_pad_table``) of ``n_table`` rows. ``draw="gaussian"`` and
    ``"sobol_gaussian"``: ``table`` is None and the growth is a + b*z
    (``gaussian_ab``). The Sobol draws take ``direction`` (int32
    (n_periods, 32|64) bits), ``sobol_shift`` (int32 (n_periods,) bits)
    and ``index_offset`` (``draw_operands``). ``keep``: float32
    (n_periods,) keep factors (read by the percent strategies); keywords
    as ``month_loop_chunk_plain``, with ``seed_base``/``tile0`` the uint32
    stream base and first global 8192-path tile and ``valid`` of the
    ``n_paths`` (a multiple of 8192) paths counting. Returns (stats, hist,
    finals-or-None) on ``keep.device``; counts its launch under the
    draw's ``MONTH_LOOP_COUNTERS`` entry."""
    if keep.device.type == "cpu":
        return month_loop_chunk_plain(table, keep, **kw)
    name = MONTH_LOOP_COUNTERS[kw.get("draw", "historical")]
    return _launch_counted(name, month_loop_launcher(table, keep, **kw))


def law_chunk(law, **kw):
    """One chunk of the terminal-law sampler. ``law``: float32
    (LAW_OP_LEN,) operand [scale, c_0 .. c_{D-1}]; keywords as
    ``law_chunk_plain`` (``seed_base`` is the law stream's base). Same
    outputs as ``month_loop_chunk`` (withdrawn row 0)."""
    if law.device.type == "cpu":
        return law_chunk_plain(law, **kw)
    return _launch_counted("law", law_launcher(law, **kw))
