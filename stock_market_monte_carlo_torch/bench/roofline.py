"""The operation and byte model of the port's kernels: the least time an
H100 could take for one call of each kernel, from the call's shapes.

Shared by ``chip_smoke.py`` (each kernel's bound) and the headline
(``bench/headline.py``: its predictions at the calibrated integer rate).

Peak rates: NVIDIA's H100 SXM data sheet (HBM, bf16 tensor cores) and the
Hopper architecture white paper (132 SMs, 4 sub-partitions of 32 lanes,
1.98 GHz boost). The data sheet gives no int32 rate; the scalar rate below
is the issue limit of any 32-bit instruction (one warp instruction per
clock per sub-partition), which is also the data sheet's 67 TFLOP/s
float32 with an FMA counted as one operation. The kernels are built with
-fmad=false, so each float op is its own instruction. The headline
measures the sustained int32 rate (``calib``) and passes it in as
``scalar_rate``.
"""

from __future__ import annotations

import math

from stock_market_monte_carlo_torch.ops import calibration as cal
from stock_market_monte_carlo_torch.ops import cuda_engine as ce

HBM_BYTES_PER_S = 3.35e12
TENSOR_BF16_FLOP_PER_S = 989e12
SCALAR_OPS_PER_S = 132 * 128 * 1.98e9

# 32-bit scalar operations, counted from the kernels' sources; a libm call
# (logf, expf, log1pf, sqrtf) counts as one, so the bounds err low.
_HASH = 8                     # finalize: 3 shifts, 3 xors, 2 multiplies
_WORD = _HASH + 2             # arith_word: + multiply, add
_IDX = 7                      # idx_exact
# u23 (4), 2u-1 (2), -log1p(-x*x) (4), the p polynomial (17), select and
# two scales (3); the q polynomial (sqrtf, -3, 16) only where w >= 5, i.e.
# |2u-1| >= sqrt(1 - e^-5)
_NORMAL_Z = 30 + 18 * (1.0 - math.sqrt(1.0 - math.exp(-5.0)))
_EPILOGUE = 25                # Stats.add (16) and bin_index + atomic (9)
# a Sobol word as the function needs it: the Gray-code recurrence along
# consecutive positions (one direction load, one XOR), then the shift XOR;
# the kernel's per-bit fold is a cost of its design, not counted
_SOBOL = 3
_XORSHIFT = 6                 # three shifts, three xors
_U23 = 4                      # shift, convert, add, scale
# binning and counting one input of the histogram kernel: the range test
# and the atomic; the cast and two clamps; HistogramSpec.bin_index (NaN
# test, max, log, subtract, scale, floor, cast, +1, two clamps, the lo
# test and its select)
_HIST_OPS = {"histogram_index": 2, "histogram_clip_cast": 5,
             "histogram": 14}
# an element-pass of each op-class toy: the instructions its chain needs
# on the card (csrc/calibration.cu's SASS record). mul an FMUL; fma an
# FMUL and an FADD (-fmad=false); iadd one add (an IADD3 takes two
# passes' adds, at 64 lanes a SM-clock: 128 adds, the assumed scalar
# rate); shf one (a shift-add); cvt the
# conversion, half a bf16x2 add and half an add; mm half a bf16x2 pack,
# the affine FMUL and FADD, beside 256 flop on the tensor cores; hash the
# finalizer's three shifts, three xors and three multiply-adds
_TOY_OPS = {"mul": 1, "fma": 2, "iadd": 1, "shf": 1, "cvt": 2, "mm": 2.5,
            "hash": 9}
_TOY_ELEMS = 4096 * 128        # a toy tile


def _io_bytes(ops, kw, rows_per_block, blocks_per_sm):
    """Bytes each input is read once and each output written once: the
    operand tensors, the per-block partial rows, the histogram and (when
    kept) the finals."""
    device = next(t.device for t in ops if t is not None)
    n_blocks = ce._launch_geometry(ce._sm_count(device), kw["valid"],
                                   rows_per_block, blocks_per_sm)
    inputs = sum(t.numel() * t.element_size() for t in ops if t is not None)
    return (inputs + n_blocks * 8 * 8 + kw["hb"] * 4
            + (kw["valid"] * 4 if kw["keep_finals"] else 0))


def work(name, ops, kw):
    """(bytes, scalar operations, tensor-core flop) of one call of kernel
    ``name`` on its wrapper's arguments ``ops``, ``kw``. Operations are
    counted from the kernel source for what the function needs; words a
    TPU row shares (the draw key of a tile-month, the source lane's word of
    the historical draw) are counted once. The calibration kernel's are
    its SASS instructions (``calibration.calib_sass_instructions``)."""
    from stock_market_monte_carlo_torch.ops import clt

    tensor_flop = 0.0
    if name.startswith("histogram"):
        # each input read once, the counts written once
        x = ops[0]
        return dict(bytes=x.numel() * x.element_size() + kw["hb"] * 4,
                    scalar_ops=float(x.numel() * _HIST_OPS[name]),
                    tensor_flop=0.0)
    if name == "flatten_tile":
        x = ops[0]
        return dict(bytes=2 * x.numel() * x.element_size(), scalar_ops=0.0,
                    tensor_flop=0.0)
    if name.startswith("grid_overhead"):
        n_tiles = kw["n_tiles"]
        nbytes = n_tiles * (ce.TILE_PATHS + cal.PARTIAL_ROWS * 128) * 4
        # counter: the word, its u23 and the column sum's add per path; two
        # tile seeds (a hash and its mixing) per tile
        scalar = (0.0 if ops[0] == "const" else
                  n_tiles * (ce.TILE_PATHS * (_WORD + _U23 + 1)
                             + 2 * (_HASH + 2)))
        return dict(bytes=nbytes, scalar_ops=scalar, tensor_flop=0.0)
    if name.startswith("calib"):
        months = cal.calib_months(kw["n_periods"])
        scalar = (kw["n_paths"] * months
                  * cal.calib_sass_instructions()[ops[0]])
        return dict(bytes=kw["n_paths"] * 4, scalar_ops=scalar,
                    tensor_flop=0.0)
    if name.startswith("op_toy"):
        op = ops[0]
        elem_passes = kw["n_tiles"] * _TOY_ELEMS * cal.TOY_PASSES
        return dict(bytes=kw["n_tiles"] * cal.TOY_OUT_ROWS * 128 * 4
                    + (128 * 128 * 2 if op == "mm" else 0),
                    scalar_ops=float(elem_passes * _TOY_OPS[op]),
                    tensor_flop=elem_passes * 256.0 if op == "mm" else 0.0)
    if name.startswith("byte_planes"):
        # per word: the word, four shifts, masks and converts; per seed its
        # key; the planes written once
        n = len(ops[0])
        words = n * 1024 * 128
        return dict(bytes=words * 16 + n * 4,
                    scalar_ops=float(words * (_WORD + 12) + n * (_HASH + 2)),
                    tensor_flop=0.0)
    if name.startswith("counts_below_tile"):
        tl, thr = ops
        # a compare and an add per (row, threshold, lane)
        return dict(bytes=(tl.numel() + 2 * thr.numel()) * 4,
                    scalar_ops=2.0 * tl.shape[0] * thr.numel(),
                    tensor_flop=0.0)
    valid = kw["valid"]
    if name.startswith("bands"):
        t = kw["n_periods"]
        if kw["draw"] == "historical":
            n = kw["n_table"]
            tail_n = n - (ops[0].numel() - 128)
            per = _WORD + _IDX + 1 + 3 * (1.0 - tail_n / n) + 13
        else:
            per = _WORD + _NORMAL_Z + 2
        keep = 0 if ops[1] is None else 1
        if name.startswith("bands_hist"):
            # fmaxf, logf, multiply, add, floorf, two clamps, convert, +1,
            # the shared-memory atomic
            reduce_ops, cells = 10, kw["n_bins"] + 2
        else:
            # what the count needs, not the kernel's binary search: the
            # interior thresholds lie on an affine log grid, so the
            # histogram's cell arithmetic and atomic give the cell; then a
            # threshold load and a compare correct it, and two compares
            # place the guard rows
            k = kw["n_thresholds"]
            reduce_ops = 10 + 4
            cells = k + 1
        # per path-month: draw, keep, compounding, reduction; per
        # tile-month the draw key
        scalar = (valid * t * (per + keep + 1 + reduce_ops)
                  + (valid / ce.TILE_PATHS) * t * _WORD)
        nbytes = (sum(x.numel() * x.element_size() for x in ops
                      if x is not None) + t * cells * 4)
    elif name.startswith("month_loop"):
        t = kw["n_periods"]
        strat = {"none": 0, "fixed_percent": 3, "variable_percent": 3,
                 "fixed_amount": 4}[kw["strategy"]]
        draw = kw["draw"]
        # per path-month: the draw, its growth; per path: the stream's
        # setup (the reference state's pcg hash); per tile-month: the
        # counter stream's draw key
        setup, key_words = 0, 0
        if draw == "historical":
            table, n = ops[0].numel(), kw["n_table"]
            tail_n = n - (table - 128)
            # own word, dest index and test, the row rotation where the
            # draw leaves the tail, the source lane's index map and the
            # shared-memory gather
            per = _WORD + _IDX + 1 + 3 * (1.0 - tail_n / n) + 13
            key_words = _WORD
        elif draw == "gaussian":
            per = _WORD + _NORMAL_Z + 2
            key_words = _WORD
        elif draw == "sobol_gaussian":
            per = _SOBOL + _NORMAL_Z + 2
        elif draw == "sobol_historical":
            per = _SOBOL + _IDX + 1
        else:
            per = _XORSHIFT + _IDX + 1
            setup = 6
        per_path = t * (per + 1 + strat) + setup + _EPILOGUE
        scalar = valid * per_path + (valid / ce.TILE_PATHS) * t * key_words
        sobol_ops = [kw.get("direction"), kw.get("sobol_shift")]
        nbytes = _io_bytes(list(ops) + sobol_ops, kw, 256, 8)
    elif name.startswith("law"):
        d = ops[0].numel() - 1
        scalar = valid * (_WORD + _NORMAL_Z + 2 + 3 * (d - 1) + 5
                          + _EPILOGUE)
        nbytes = _io_bytes(ops, kw, 256, 8)
    elif name.startswith("clt"):
        nblocks = ops[1].shape[0]
        k = clt.CLT_K
        # per block: k words, each shifted, converted and rounded to bf16
        # (nomm: scaled by 2^-9); the affine step; then the product over
        # blocks (plain) or the prefix step per column (gk, exp,
        # excl*g*(1-k), add, max, log, add) and the carry (prefix). The
        # probes (kw["ablate"]) take out what they remove: nodraw draws the
        # words of one block, nohist the binning, nologexp the logs and the
        # exp (a sum and two scales left), nomm the product
        ablate = kw.get("ablate", "base")
        draw = k * (_WORD + 3)
        per_block = 2 * k
        if kw.get("variant", "plain") == "prefix":
            per_block += 9 * k + 6
            finish = 1
        else:
            per_block += k
            finish = k + 2 if ablate == "nologexp" else 2 * k + 2
        epilogue = _EPILOGUE - 9 if ablate == "nohist" else _EPILOGUE
        draws = 1 if ablate == "nodraw" else nblocks
        scalar = valid * (draws * draw + nblocks * per_block + finish
                          + epilogue)
        tensor_flop = (0.0 if ablate == "nomm"
                       else valid * nblocks * 2.0 * k * k)
        nbytes = _io_bytes(ops, kw, 64, 2)
        if ablate == "nohist":
            nbytes -= kw["hb"] * 4
    else:
        raise ValueError(name)
    return dict(bytes=nbytes, scalar_ops=scalar, tensor_flop=tensor_flop)


def bound(name, ops, kw, scalar_rate=SCALAR_OPS_PER_S):
    """(bound_ms, bound_by, work) for one call of kernel ``name``: the
    larger of the bytes over the HBM rate and each kind of operation over
    its peak rate, 32-bit scalar operations at ``scalar_rate``."""
    w = work(name, ops, kw)
    t_bytes = w["bytes"] / HBM_BYTES_PER_S
    t_ops = max(w["scalar_ops"] / scalar_rate,
                w["tensor_flop"] / TENSOR_BF16_FLOP_PER_S)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", w
    return t_ops * 1e3, "operations", w
