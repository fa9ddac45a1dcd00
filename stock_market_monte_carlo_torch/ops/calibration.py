"""The headline benchmark's calibration kernels, as hand-written CUDA
kernels and their plain PyTorch versions.

Counterpart of the two TPU experiments that ``bench.py`` times:

- ``grid_overhead_chunk`` replaces ``experiments/exp_grid_overhead.py:_make``
  (``pl.pallas_call`` at :66), the dispatch floor: per 8192-path tile,
  finals (64, 128) and partials (8, 128), constants (``"const"``) or the
  tile's u23 uniforms and their column sum (``"counter"``), with ``group``
  tiles to a block;
- ``calib_chunk`` replaces ``experiments/exp_hist_roofline.py:
  make_calib_call`` (:102), the issue-rate probe: per path a serial chain
  of ``n_ops`` 32-bit integer operators a month, over ``(n_periods // 8) *
  8`` months, folded into a float32 product.

Source ``csrc/calibration.cu``. The TPU kernels draw the hardware PRNG; the
port draws the arithmetic counter stream from the same seeds (key 0 of
``_TileRng(seed, "arith")``), as everywhere else in the port. The plain
versions hold uint32 values in int64 tensors and reuse the counter-stream
helpers of ``cuda_engine``.

Each wrapper runs its plain version only when asked for ``device="cpu"``;
on a CUDA device it launches the kernel or raises. Launches count under
``cuda_engine.LAUNCHES["grid_overhead"]`` and ``["calib"]``.
"""

from __future__ import annotations

import ctypes
import functools
import re
import subprocess
from pathlib import Path

import torch

from stock_market_monte_carlo_torch.ops import cuda_engine as ce

VARIANTS = {"const": 0, "counter": 1}
PARTIAL_ROWS = 8
# the kernel's instances; the plain version takes any multiple of 4
CALIB_OPS = (16, 48)
CALIB_UNROLL = 8
CALIB_MUL = 2654435761           # the TPU kernel's int32 -1640531535
CALIB_SCALE = ce._f32(1e-12)


# ---------------------------------------------------------------------------
# Grid overhead.
# ---------------------------------------------------------------------------


def _check_grid(variant, group, n_tiles):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if group < 1 or n_tiles < 1 or n_tiles % group:
        raise ValueError(f"{n_tiles} tiles do not split into groups of "
                         f"{group}")


def grid_overhead_chunk_plain(variant, group, *, seed, n_tiles, tile0=0,
                              device="cpu"):
    """Plain PyTorch version of the grid-overhead kernel on ``device``:
    (finals (n_tiles*64, 128), partials (n_tiles*8, 128)) float32. The
    counter variant's column sums run over the rows in order, as the
    kernel sums them; ``group`` changes no value."""
    _check_grid(variant, group, n_tiles)
    dev = torch.device(device)
    if variant == "const":
        return (torch.full((n_tiles * ce.TILE_ROWS, 128), 1.0,
                           dtype=torch.float32, device=dev),
                torch.full((n_tiles * PARTIAL_ROWS, 128), 2.0,
                           dtype=torch.float32, device=dev))
    tiles = (int(tile0) + torch.arange(n_tiles, device=dev)) & ce.MASK32
    seeds = ce._tile_seed_i32(int(seed) & ce.MASK32, tiles)[:, None]
    pos = torch.arange(ce.TILE_PATHS, device=dev)[None, :]
    u = ce._u23_from_bits(ce._arith_bits(seeds, 0, pos)).reshape(
        n_tiles, ce.TILE_ROWS, 128)
    s = torch.zeros((n_tiles, 128), dtype=torch.float32, device=dev)
    for r in range(ce.TILE_ROWS):
        s = s + u[:, r]
    partials = s[:, None, :].expand(n_tiles, PARTIAL_ROWS, 128)
    return u.reshape(-1, 128), partials.reshape(-1, 128)


def grid_overhead_launcher(variant, group, *, seed, n_tiles, tile0=0,
                           device="cuda"):
    """Checked inputs of one grid-overhead chunk on a CUDA device ->
    ``(launch, outputs)``: ``launch()`` runs the kernel on the current
    stream, uncounted; ``outputs()`` returns (finals, partials)."""
    from stock_market_monte_carlo_torch.ops._build import load_library

    _check_grid(variant, group, n_tiles)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no grid-overhead kernel for device {dev}")
    finals = torch.empty((n_tiles * ce.TILE_ROWS, 128), dtype=torch.float32,
                         device=dev)
    partials = torch.empty((n_tiles * PARTIAL_ROWS, 128),
                           dtype=torch.float32, device=dev)
    args = (VARIANTS[variant], int(seed) & ce.MASK32, int(tile0) & ce.MASK32,
            group, n_tiles // group, ce._ptr(finals), ce._ptr(partials),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    fn = load_library().smmc_grid_overhead

    def launch():
        ce._raise_on(fn(*args), "smmc_grid_overhead")

    return launch, lambda: (finals, partials)


def grid_overhead_chunk(variant, group, *, seed, n_tiles, tile0=0,
                        device="cuda"):
    """One grid-overhead chunk of ``n_tiles`` 8192-path tiles, ``group``
    tiles to a block, the first at global tile ``tile0``: (finals
    (n_tiles*64, 128), partials (n_tiles*8, 128)) float32 on ``device``.
    ``"const"`` writes 1.0 and 2.0; ``"counter"`` the u23 uniforms of key 0
    of each tile's stream ``_tile_seed_i32(seed, tile)`` and their column
    sums. Counts its launch under ``grid_overhead``."""
    if torch.device(device).type == "cpu":
        return grid_overhead_chunk_plain(variant, group, seed=seed,
                                         n_tiles=n_tiles, tile0=tile0)
    return ce._launch_counted("grid_overhead", grid_overhead_launcher(
        variant, group, seed=seed, n_tiles=n_tiles, tile0=tile0,
        device=device))


# ---------------------------------------------------------------------------
# Calibration.
# ---------------------------------------------------------------------------


def _check_calib(n_ops, n_periods, n_paths):
    if n_ops < 4 or n_ops % 4:
        raise ValueError(f"n_ops must be a positive multiple of 4, got "
                         f"{n_ops}")
    if n_periods < 1:
        raise ValueError(f"n_periods must be positive, got {n_periods}")
    if n_paths < ce.TILE_PATHS or n_paths % ce.TILE_PATHS \
            or n_paths >= 1 << 31:
        raise ValueError(f"n_paths must be a multiple of {ce.TILE_PATHS} "
                         f"below 2^31, got {n_paths}")


def calib_months(n_periods):
    """Months the calibration kernel runs: whole 8-month iterations."""
    return (n_periods // CALIB_UNROLL) * CALIB_UNROLL


def _calib_plain(n_ops, *, n_periods, n_paths, seed, device="cpu"):
    """The plain calibration chain: (the last month's words as an int64
    tensor of uint32, the (n_paths // 128, 128) float32 totals)."""
    _check_calib(n_ops, n_periods, n_paths)
    dev = torch.device(device)
    gid = torch.arange(n_paths, dtype=torch.int64, device=dev)
    seeds = (int(seed) + gid // ce.TILE_PATHS) & ce.MASK32
    y = ce._arith_bits(seeds, 0, gid % ce.TILE_PATHS)
    total = torch.ones((n_paths,), dtype=torch.float32, device=dev)
    for _ in range(calib_months(n_periods)):
        for k in range(n_ops // 4):
            y = y ^ ((y << 5) & ce.MASK32)
            y = y ^ (y >> 7)
            y = ce._mul32(y, CALIB_MUL)
            y = (y + (k + 1)) & ce.MASK32
        signed = torch.where(y >= 1 << 31, y - (1 << 32), y)
        total = total * (1.0 + signed.to(torch.float32) * CALIB_SCALE)
    return y, total.reshape(-1, 128)


def calib_chunk_plain(n_ops, *, n_periods, n_paths, seed, device="cpu"):
    """Plain PyTorch version of the calibration kernel on ``device``: the
    (n_paths // 128, 128) float32 totals."""
    return _calib_plain(n_ops, n_periods=n_periods, n_paths=n_paths,
                        seed=seed, device=device)[1]


def calib_launcher(n_ops, *, n_periods, n_paths, seed, device="cuda"):
    """Checked inputs of one calibration chunk on a CUDA device ->
    ``(launch, outputs)``: ``launch()`` runs the kernel, uncounted;
    ``outputs()`` returns the totals."""
    from stock_market_monte_carlo_torch.ops._build import load_library

    _check_calib(n_ops, n_periods, n_paths)
    if n_ops not in CALIB_OPS:
        raise ValueError(f"the kernel is built for n_ops in {CALIB_OPS}, "
                         f"got {n_ops}")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no calibration kernel for device {dev}")
    out = torch.empty((n_paths // 128, 128), dtype=torch.float32, device=dev)
    args = (n_ops, int(seed) & ce.MASK32,
            n_periods // CALIB_UNROLL, n_paths, ce._ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    fn = load_library().smmc_calib

    def launch():
        ce._raise_on(fn(*args), "smmc_calib")

    return launch, lambda: out


def calib_chunk(n_ops, *, n_periods, n_paths, seed, device="cuda"):
    """One calibration chunk of ``n_paths`` paths (a multiple of 8192; tile
    ``t`` seeded ``seed + t``, so a tile offset adds to the seed): the
    (n_paths // 128, 128) float32 totals on ``device``. Counts its launch
    under ``calib``."""
    if torch.device(device).type == "cpu":
        return calib_chunk_plain(n_ops, n_periods=n_periods, n_paths=n_paths,
                                 seed=seed)
    return ce._launch_counted("calib", calib_launcher(
        n_ops, n_periods=n_periods, n_paths=n_paths, seed=seed,
        device=device))


# ---------------------------------------------------------------------------
# Instructions of the built kernels.
# ---------------------------------------------------------------------------

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"BRA\s+(0x[0-9a-f]+)")


def loop_instructions(sass: str) -> int:
    """Instructions in the longest loop of one function's SASS listing (as
    ``cuobjdump -sass`` prints it, branches to addresses): from a branch's
    target to the branch, for every branch that jumps back. NOPs do not
    count."""
    instrs, addrs = [], {}
    for line in sass.splitlines():
        m = _INSTR.match(line)
        if m and not m.group(2).startswith("NOP"):
            addrs[int(m.group(1), 16)] = len(instrs)
            instrs.append(m.group(2))
    best = 0
    for j, ins in enumerate(instrs):
        m = _TARGET.search(ins)
        if not m:
            continue
        i = addrs.get(int(m.group(1), 16))
        if i is not None and i <= j:
            best = max(best, j - i + 1)
    if best == 0:
        raise ValueError("no loop in the listing")
    return best


@functools.lru_cache(maxsize=1)
def calib_sass_instructions() -> dict:
    """{n_ops: SASS instructions of one month} of each calibration kernel
    in the built library: its month loop's body (8 months and the loop's
    own count, compare and branch) over 8, read with ``cuobjdump -sass``
    from the toolkit beside nvcc. Needs the toolkit, not a card."""
    from stock_market_monte_carlo_torch.ops import _build

    tool = Path(_build._find_nvcc()).with_name("cuobjdump")
    listing = subprocess.run([str(tool), "-sass", str(_build.build())],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
    funcs = listing.split("Function : ")[1:]
    out = {}
    for n_ops in CALIB_OPS:
        body = [f for f in funcs if f"calib_kernelILi{n_ops}E" in
                f.split("\n", 1)[0]]
        if len(body) != 1:
            raise RuntimeError(f"calib_kernel<{n_ops}> appears {len(body)} "
                               "times in the library's SASS")
        out[n_ops] = loop_instructions(body[0]) / CALIB_UNROLL
    return out
