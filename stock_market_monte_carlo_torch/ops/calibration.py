"""The headline benchmark's calibration kernels and the CLT's op-class
toys, as hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of the two TPU experiments that ``bench.py`` times, and of the
toys of ``experiments/exp_clt_roofline.py``:

- ``grid_overhead_chunk`` replaces ``experiments/exp_grid_overhead.py:_make``
  (``pl.pallas_call`` at :66), the dispatch floor: per 8192-path tile,
  finals (64, 128) and partials (8, 128), constants (``"const"``) or the
  tile's u23 uniforms and their column sum (``"counter"``), with ``group``
  tiles to a block;
- ``calib_chunk`` replaces ``experiments/exp_hist_roofline.py:
  make_calib_call`` (:102), the issue-rate probe: per path a serial chain
  of ``n_ops`` 32-bit integer operators a month, over ``(n_periods // 8) *
  8`` months, folded into a float32 product;
- ``op_toy_chunk`` replaces ``experiments/exp_clt_roofline.py:_make_toy``
  (:104): per (4096, 128) tile a carried chain of 12 passes of one op class
  (``TOY_OPS``), rows 0-7 of each tile written out. ``hash`` is the port's
  own seventh class, the counter word the CLT hashes per count.

Source ``csrc/calibration.cu``. The TPU kernels draw the hardware PRNG; the
port draws the arithmetic counter stream from the same seeds (key 0 of
``_TileRng(seed, "arith")``), as everywhere else in the port. The plain
versions hold uint32 values in int64 tensors and reuse the counter-stream
helpers of ``cuda_engine``.

Each wrapper runs its plain version only when asked for ``device="cpu"``;
on a CUDA device it launches the kernel or raises. Launches count under
``cuda_engine.LAUNCHES["grid_overhead"]``, ``["calib"]`` and
``["op_toy_<op>"]``.
"""

from __future__ import annotations

import collections
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
# the toys: op class -> the kernel's code; the experiment's six classes
# first, then the port's own
TOY_OPS = {"mul": 0, "fma": 1, "iadd": 2, "shf": 3, "cvt": 4, "mm": 5,
           "hash": 6}
EXPERIMENT_OPS = ("mul", "fma", "iadd", "shf", "cvt", "mm")
TOY_ROWS = 4096                  # exp_clt_roofline.P (CLT_P)
TOY_TILES = 4096                 # exp_clt_roofline.GRID: 2^24 paths
TOY_PASSES = 12                  # exp_clt_roofline.REPS_IN_KERNEL
TOY_OUT_ROWS = 8
TOY_C = ce._f32(1.0000001)       # the toy's fscal[0] and fscal[1]
TOY_A = ce._f32(0.0000002)
TOY_XI0, TOY_CI = 3, 1
# chains a thread of each instance (csrc/calibration.cu kToyChains; mm: a
# thread's 64 accumulators)
TOY_CHAINS = {op: 64 if op == "mm" else 16 for op in TOY_OPS}
# hard starts of the cvt toy's chains, at which the tests and chip_smoke.py
# hold the kernel to its plain version: chains on either side of +-2^22,
# a value that bf16(float32(xi)) rounds twice (2^24 + 2^16 + 1: 2^24,
# where one rounding gives 2^24 + 2^17), its negative, and a chain ending
# at 2^31 - 1
TOY_CVT_HARD_XI0 = (3, -(1 << 22) + 20, (1 << 22) - 13, (1 << 22) - 5,
                    16842753, -16842753, (1 << 31) - 13)
# hard starts of the shf toy's chains: bit 31 set (a logical shift brings
# in a 0, an arithmetic one a 1) and the largest int32
TOY_SHF_HARD_XI0 = (-1, -3, -(1 << 31), -(1 << 31) + 1, (1 << 31) - 1)


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

    def launch(held=(finals, partials)):  # for the kernel
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

    def launch(held=(out,)):  # for the kernel
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
# The CLT's op-class toys.
# ---------------------------------------------------------------------------


def _check_toy(op, n_tiles, xi0=TOY_XI0):
    if op not in TOY_OPS:
        raise ValueError(f"unknown op class {op!r}")
    if n_tiles < 1 or n_tiles > TOY_TILES * 16:
        raise ValueError(f"n_tiles must be in [1, {TOY_TILES * 16}], got "
                         f"{n_tiles}")
    # iadd and cvt add ci each pass; shf and hash run on uint32 bits
    last = xi0 + TOY_PASSES * TOY_CI if op in ("iadd", "cvt") else xi0
    if not -(1 << 31) <= min(xi0, last) <= max(xi0, last) < 1 << 31:
        raise ValueError(f"xi0 = {xi0}: the chains leave int32")


def _round_bits(v, bits):
    """Non-negative int64 ``v`` rounded to ``bits`` significant bits, to
    nearest, ties to even (exact below 2^62)."""
    out = v.clone()
    for shift in range(1, 63 - bits):
        over = v >= 1 << (bits + shift - 1)
        if not bool(over.any()):
            break
        q, rem, half = v >> shift, v & ((1 << shift) - 1), 1 << (shift - 1)
        q = q + ((rem > half) | ((rem == half) & ((q & 1) == 1))).long()
        out = torch.where(over, q << shift, out)
    return out


def cvt_bf16_twin(xi):
    """The cvt kernel's conversion of int32 values (any integer tensor) to
    bfloat16, step by step in integer arithmetic, as float32 values:
    ``__int2float_rn``, xi rounded to 24 significant bits, then
    ``__floats2bfloat162_rn``, that float rounded to 8; each to nearest,
    ties to even. bf16(float32(xi)): torch's and XLA's int-to-bf16 cast,
    two roundings past 2^24."""
    xi = torch.as_tensor(xi).to(torch.int64)
    out = _round_bits(_round_bits(xi.abs(), 24), 8).to(torch.float32)
    return torch.where(xi < 0, -out, out)


def _toy_tile(op, device, xi0=TOY_XI0):
    """One (4096, 128) tile of class ``op`` after its 12 passes, float32,
    as the toy writes it (iadd, shf: xi as int32; cvt: bacc + xi; hash: the
    word's top 24 bits; else x). torch's own ops in the toy's types:
    float32, a bfloat16 accumulator, ``bf16 @ bf16`` accumulated in float32
    for mm (TF32 off). The integer chains start at ``xi0``; shf and hash
    run on uint32 bits, iadd and cvt never leave int32 (``_check_toy``)."""
    from stock_market_monte_carlo_torch.ops import clt

    dev = torch.device(device)
    shape = (TOY_ROWS, 128)
    if op in ("mul", "fma", "mm"):
        torch.backends.cuda.matmul.allow_tf32 = False
        qf = clt.q_tensor(dev).to(torch.float32) if op == "mm" else None
        x = torch.full(shape, 1.0, dtype=torch.float32, device=dev) * TOY_C
        for _ in range(TOY_PASSES):
            if op == "mul":
                x = x * TOY_C
            elif op == "fma":
                x = TOY_A + x * TOY_C
            else:
                y = x.to(torch.bfloat16).to(torch.float32) @ qf
                x = TOY_A + y * TOY_C
        return x
    xi = torch.full(shape, xi0, dtype=torch.int64, device=dev)
    bacc = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    for _ in range(TOY_PASSES):
        if op == "iadd":
            xi = xi + TOY_CI
        elif op == "shf":
            xi = (((xi & ce.MASK32) >> 1) + TOY_CI) & ce.MASK32  # logical
        elif op == "cvt":
            bacc = bacc + xi.to(torch.bfloat16)
            xi = xi + TOY_CI
        else:
            xi = ce._finalize((xi + TOY_CI * ce._GOLDEN) & ce.MASK32)
    if op == "cvt":
        return bacc.to(torch.float32) + xi.to(torch.float32)
    if op == "hash":
        return (xi >> 8).to(torch.float32)
    xi = xi & ce.MASK32
    return torch.where(xi >= 1 << 31, xi - (1 << 32), xi).to(torch.float32)


def op_toy_chunk_plain(op, n_tiles=TOY_TILES, device="cpu", *,
                       xi0=TOY_XI0):
    """Plain PyTorch version of the toy kernel on ``device``: (n_tiles *
    8, 128) float32, rows 0-7 of each tile. Every tile is the same, so it
    computes one tile and repeats it. ``xi0``: the integer chains' start
    (the tests' hard inputs)."""
    _check_toy(op, n_tiles, xi0)
    rows = _toy_tile(op, device, xi0)[:TOY_OUT_ROWS]
    return rows.repeat(n_tiles, 1)


def op_toy_launcher(op, n_tiles=TOY_TILES, device="cuda", *, xi0=TOY_XI0):
    """Checked inputs of one toy on a CUDA device -> ``(launch,
    outputs)``: ``launch()`` runs the kernel, uncounted; ``outputs()``
    returns the (n_tiles * 8, 128) rows. ``xi0``: the integer chains'
    start (the tests' hard inputs)."""
    from stock_market_monte_carlo_torch.ops import clt
    from stock_market_monte_carlo_torch.ops._build import load_library

    _check_toy(op, n_tiles, xi0)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no toy kernel for device {dev}")
    q = clt.q_tensor(dev) if op == "mm" else None
    out = torch.empty((n_tiles * TOY_OUT_ROWS, 128), dtype=torch.float32,
                      device=dev)
    args = (TOY_OPS[op], TOY_C, TOY_A, int(xi0), TOY_CI, ce._ptr(q), n_tiles,
            ce._ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    fn = load_library().smmc_op_toy

    def launch(held=(q, out)):  # for the kernel
        ce._raise_on(fn(*args), "smmc_op_toy")

    return launch, lambda: out


def op_toy_chunk(op, n_tiles=TOY_TILES, device="cuda"):
    """One toy of class ``op`` (``TOY_OPS``) over ``n_tiles`` (4096, 128)
    tiles (4096: a 2^24-path chunk equivalent, 2^31 elements): the (n_tiles
    * 8, 128) float32 rows 0-7 of each tile on ``device``. Counts its
    launch under ``op_toy_<op>``."""
    if torch.device(device).type == "cpu":
        return op_toy_chunk_plain(op, n_tiles)
    return ce._launch_counted(f"op_toy_{op}", op_toy_launcher(op, n_tiles,
                                                              device))


# ---------------------------------------------------------------------------
# Instructions of the built kernels.
# ---------------------------------------------------------------------------

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"BRA\s+(0x[0-9a-f]+)")


def _instructions(sass: str):
    """(instruction texts, {address: index}) of one function's SASS listing
    (as ``cuobjdump -sass`` prints it, branches to addresses), NOPs left
    out."""
    instrs, addrs = [], {}
    for line in sass.splitlines():
        m = _INSTR.match(line)
        if m and not m.group(2).startswith("NOP"):
            addrs[int(m.group(1), 16)] = len(instrs)
            instrs.append(m.group(2))
    return instrs, addrs


def loop_body(sass: str, holding: str | None = None) -> list:
    """The instructions of the longest loop of one function's SASS listing,
    or with ``holding`` the shortest loop that holds an instruction of
    that opcode: from a branch's target to the branch, for every branch
    that jumps back. NOPs do not count."""
    instrs, addrs = _instructions(sass)
    loops = []
    for j, ins in enumerate(instrs):
        m = _TARGET.search(ins)
        i = addrs.get(int(m.group(1), 16)) if m else None
        if i is not None and i <= j:
            loops.append(instrs[i:j + 1])
    if holding is not None:
        loops = sorted((b for b in loops if holding in opcodes(b)), key=len)
    else:
        loops = sorted(loops, key=len, reverse=True)
    if not loops:
        raise ValueError(f"no loop{f' holding {holding}' if holding else ''}"
                         " in the listing")
    return loops[0]


def loop_instructions(sass: str) -> int:
    """Instructions in the longest loop of one function's SASS listing."""
    return len(loop_body(sass))


def opcodes(instrs) -> list:
    """The opcodes of instruction texts, without predicate or modifiers."""
    out = []
    for ins in instrs:
        words = ins.split()
        op = words[1] if words[0].startswith("@") else words[0]
        out.append(op.split(".")[0])
    return out


@functools.lru_cache(maxsize=4)
def sass_functions(library=None) -> dict:
    """{mangled name: SASS listing} of every kernel in ``library`` (default:
    the built library), read with ``cuobjdump -sass`` from the toolkit
    beside nvcc. Needs the toolkit, not a card."""
    from stock_market_monte_carlo_torch.ops import _build

    tool = Path(_build._find_nvcc()).with_name("cuobjdump")
    listing = subprocess.run([str(tool), "-sass",
                              str(library or _build.build())],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
    return {f.split("\n", 1)[0].strip(): f
            for f in listing.split("Function : ")[1:]}


def clt_production_sass(library=None) -> dict:
    """{variant code: SASS instructions (NOPs left out)} of the production
    CLT kernels in ``library``: ``clt_kernel<V>`` of a build before the
    probe instances, ``clt_kernel<V, 0>`` after. The probe instances must
    leave these counts as they were."""
    out = {}
    for name, body in sass_functions(library).items():
        m = re.search(r"clt_kernelILi(\d)E(Li0E)?E", name)
        if m:
            out[int(m.group(1))] = len(_instructions(body)[0])
    return out


def sass_function(fragment: str) -> str:
    """The one listing of ``sass_functions`` whose name holds
    ``fragment``."""
    found = [body for name, body in sass_functions().items()
             if fragment in name]
    if len(found) != 1:
        raise RuntimeError(f"{fragment} appears {len(found)} times in the "
                           "library's SASS")
    return found[0]


@functools.lru_cache(maxsize=1)
def calib_sass_instructions() -> dict:
    """{n_ops: SASS instructions of one month} of each calibration kernel
    in the built library: its month loop's body (8 months and the loop's
    own count, compare and branch) over 8."""
    return {n_ops: loop_instructions(sass_function(
        f"calib_kernelILi{n_ops}E")) / CALIB_UNROLL for n_ops in CALIB_OPS}


def op_toy_sass() -> dict:
    """{op: {"instructions": n, "per_element_pass": n / (12 * chains),
    "opcodes": {opcode: count}}} of each toy instance in the built library.
    The non-mm instances are straight-line code (12 passes of 16 chains
    unrolled): every instruction counts, the chains' setup and the stores
    with them. mm runs its passes as a loop inside the loop over its
    groups: the pass loop's body (the shortest loop holding an HGMMA), one
    pass of a thread's 64 accumulators."""
    out = {}
    for op, code in TOY_OPS.items():
        sass = sass_function(f"op_toy_kernelILi{code}E")
        if op == "mm":
            body, passes = loop_body(sass, holding="HGMMA"), 1
        else:
            body, passes = _instructions(sass)[0], TOY_PASSES
        out[op] = dict(instructions=len(body),
                       per_element_pass=len(body) / (passes
                                                     * TOY_CHAINS[op]),
                       opcodes=dict(collections.Counter(opcodes(body))))
    return out
