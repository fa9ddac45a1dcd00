"""The CLT Gaussian sampler: a hand-written CUDA kernel (``csrc/clt.cu``)
and its plain PyTorch version.

Counterpart of ``stock_market_monte_carlo_tpu/ops/pallas_engine.py``
``_build_clt_kernel`` / ``_clt_chunk_stats``. Instead of one inverse CDF
per path-month, a tile draws a (P, 128) block of 16-bit counts per 128
months and mixes it through the vendored orthogonal matrix Q: each month's
z is a weighted sum of 128 i.i.d. uniforms, centred and scaled by exact
per-column constants (``clt_qmatrix``).

The stream, as the JAX kernel draws it under ``SMMC_PRNG_IMPL=arith``:

- stream base ``seed_base ^ CLT_STREAM_XOR``; tiles of ``CLT_P`` = 4096
  paths, or ``CLT_P_STRATEGY`` = 2048 for the prefix variant, indexed
  globally (first tile of a chunk = path offset // tile paths);
- block j of tile T draws word ``arith_word(tile_seed(tile_seed(base, T),
  j), p_local*128 + c)`` for path row p_local of the tile and month
  column c; the count is the word's top 16 bits, rounded to bf16 (round to
  nearest even: part of the stream);
- ``zraw = bf16(count) @ Q`` with float32 accumulation; growth =
  ``arow[j, c] + zraw * cs[j, c]`` (``block_consts``).

Three variants (``VARIANTS``), as the engine routes them:

- ``plain``: product over blocks per (path, column), then
  finals = v0 * exp(sum_c log prod);
- ``keep_fold``: the same, with the keep factors of a percent strategy
  folded into ``arow`` and ``cs`` (finals exact, withdrawn not tracked);
- ``prefix``: the percent strategy with the withdrawn total, by a
  log-space exclusive prefix along each 128-month row. The JAX kernel
  takes it as a strictly-lower-triangular matrix product; the plain
  version as a running sum along the row, the CUDA kernel as running
  sums over each lane's runs of months and scans over the quad of lanes
  (``prefix_finish_twin``): the same function, within the bars.

``clt_chunk`` takes its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises. Launches count under
``cuda_engine.LAUNCHES["clt"]``.

``clt_probe_chunk`` runs the plain variant through the kernel's probe
instances (``smmc_clt_probe``), the counterparts of two experiments:
``experiments/exp_clt_ablate.py`` (``ABLATIONS``: ``base`` removes
nothing; ``nohist`` the histogram; ``nologexp`` finals = (v0 * sum_c
prod_c) / 128 in place of v0 * exp(sum_c log prod_c); ``nodraw`` draws key 0
once for all blocks; ``nomm`` takes zraw = float(count) * 2^-9 with no
product) and ``experiments/exp_clt_ts2.py`` (``tiles_per_block``: 0 strides
the blocks as ``clt_chunk`` does, TS of ``GROUPINGS`` >= 1 gives a block
TS stream tiles). Its stats are the experiments' raw partial sums: powers
of the finals themselves (no /v0, no shift), min and max of the finals, in
float64. Launches count under ``LAUNCHES["clt_probe_<ablate>"]`` at TS = 0
and under ``LAUNCHES["clt_probe_ts<TS>"]`` otherwise.
"""

from __future__ import annotations

import functools
import hashlib
import io
from pathlib import Path

import numpy as np
import torch

from stock_market_monte_carlo_torch.ops import cuda_engine as ce

CLT_P = 4096            # paths per tile (plain and keep-fold)
CLT_P_STRATEGY = 2048   # paths per tile with the prefix strategy
CLT_K = 128             # months per block = mixing dimension
CLT_STREAM_XOR = 0x11C7  # the CLT stream family
VARIANTS = {"plain": 0, "keep_fold": 1, "prefix": 2}
# the prefix kernel's months a lane sums in order before its quad's scan
# (``csrc/clt.cu`` kRun)
PREFIX_RUN = 8
# the prefix kernel's finish order (``prefix_scan_twin``), in the
# checkpoint tag of the clt-prefix sampler: a checkpoint of another order
# rounds its withdrawn sums otherwise and is refused
PREFIX_FINISH = "quadscan"
ABLATIONS = {"base": 1, "nohist": 2, "nologexp": 3, "nodraw": 4, "nomm": 5}
# exp_clt_ts2.py's TS = 2 and its neighbours; 0 is clt_chunk's geometry
GROUPINGS = (0, 1, 2, 4)
_NOMM_SCALE = 2.0 ** -9    # zraw of the nomm ablation: count * 2^-9

# sha256 of the vendored _clt_q128.npy bytes: the matrix defines the stream
_CLT_Q128_SHA256 = (
    "b8f8958ee25e0a8a4c30671c945a3d87cb71a666292d0ae5dee9353161e36907"
)
_Q_PATH = Path(__file__).resolve().parent / "_clt_q128.npy"

_ROWS = 64              # paths per CUDA block (csrc/clt.cu kRows)
# at most 4 blocks a SM (2 are resident at the kernel's registers): 1 %
# faster than 2, and 3 leaves a wave partly idle (PERF.md)
_BLOCKS_PER_SM = 4
# the prefix variant: 2 blocks a SM, level with 3 (both resident at its
# registers) and 1.18x faster than 4 (PERF.md)
_PREFIX_BLOCKS_PER_SM = 2
_SLAB = 1 << 18         # paths per slab of the plain version


def tile_paths(variant: str) -> int:
    """Paths per stream tile of a variant."""
    return CLT_P_STRATEGY if variant == "prefix" else CLT_P


@functools.lru_cache(maxsize=1)
def clt_qmatrix():
    """(Q, colscale, colshift): Q as its bf16 bit patterns, uint16
    (128 months in, 128 columns out), and the float32 (128,) constants of
    the exact affine map z_c = (cnt @ Q)_c * colscale_c - colshift_c that
    gives z mean 0 and variance 1 for counts uniform over [0, 2^16)
    (``pallas_engine._clt_qmatrix``, in float64 over the bf16 values)."""
    raw = _Q_PATH.read_bytes()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != _CLT_Q128_SHA256:
        raise RuntimeError(
            f"_clt_q128.npy sha256 mismatch: got {digest}, expected "
            f"{_CLT_Q128_SHA256}; the vendored CLT mixing matrix defines "
            "the sample stream"
        )
    bits = np.load(io.BytesIO(raw))
    q64 = torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).to(torch.float64).numpy()
    colnorm = np.sqrt((q64 ** 2).sum(axis=0))
    colsum = q64.sum(axis=0)
    s_corr = np.sqrt(12.0 / (1.0 - 2.0**-32))
    colscale = (2.0**-16 * s_corr / colnorm).astype(np.float32)
    colshift = (32767.5 * 2.0**-16 * s_corr * colsum
                / colnorm).astype(np.float32)
    return bits.view(np.uint16), colscale, colshift


def q_tensor(device) -> torch.Tensor:
    """Q as a bfloat16 (128, 128) tensor on ``device``."""
    bits = clt_qmatrix()[0]
    return torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).to(device)


def block_consts(a, b, n_periods, keep=None):
    """(arow, cs): float32 (nblocks, 128) per-column growth constants,
    growth = arow + zraw * cs, built as ``block_consts`` of the JAX kernel:
    arow = a - colshift*b and cs = colscale*b; with ``keep`` (the
    keep-fold variant, (n_periods,) float32) both are multiplied by the
    month's keep factor. Columns past ``n_periods`` take arow 1, cs 0."""
    _, colscale, colshift = clt_qmatrix()
    a, b = np.float32(a), np.float32(b)
    nblocks = -(-n_periods // CLT_K)
    base_a = a - colshift * b
    base_c = colscale * b
    live = (np.arange(nblocks * CLT_K) < n_periods).reshape(nblocks, CLT_K)
    arow = np.broadcast_to(base_a, live.shape)
    cs = np.broadcast_to(base_c, live.shape)
    if keep is not None:
        k = keep_rows(keep, n_periods)
        arow, cs = k * arow, k * cs
    return (np.where(live, arow, np.float32(1.0)).astype(np.float32),
            np.where(live, cs, np.float32(0.0)).astype(np.float32))


def keep_rows(keep, n_periods):
    """(n_periods,) keep factors padded with 1 to (nblocks, 128)."""
    nblocks = -(-n_periods // CLT_K)
    rows = np.ones((nblocks * CLT_K,), np.float32)
    rows[:n_periods] = np.asarray(keep, np.float32)[:n_periods]
    return rows.reshape(nblocks, CLT_K)


def _growth_blocks(qf, arow, cs, seed_base, tile0, rows, p_tile,
                   ablate="base"):
    """Growth factors (len(rows), 128) of each block j, in order, for the
    chunk-local paths ``rows`` (``ablate`` "nodraw": key 0 for every
    block; "nomm": zraw = count * 2^-9, no product)."""
    dev = qf.device
    seeds = ce._tile_seed_i32(int(seed_base) & ce.MASK32,
                              (int(tile0) + rows // p_tile) & ce.MASK32)
    pos = (rows % p_tile)[:, None] * CLT_K + torch.arange(CLT_K, device=dev)
    pos_term = ce._mul32(pos, ce._GOLDEN)
    for j in range(arow.shape[0]):
        h = ce._tile_seed_i32(seeds, 0 if ablate == "nodraw" else j)[:, None]
        w = ce._finalize((h + pos_term) & ce.MASK32)
        if ablate == "nomm":
            zraw = (w >> 16).to(torch.float32) * _NOMM_SCALE
        else:
            cnt = (w >> 16).to(torch.float32).to(torch.bfloat16).to(
                torch.float32)
            zraw = cnt @ qf
        yield arow[j] + zraw * cs[j]


def _block_product(blocks, n, dev):
    """(n, 128) product over the blocks' growth factors, in block order."""
    prod = torch.ones((n, CLT_K), dtype=torch.float32, device=dev)
    for g in blocks:
        prod = prod * g
    return prod


def row_products(q, arow, cs, *, seed_base, tile0, rows, p_tile=CLT_P,
                 ablate="base"):
    """(len(rows), 128) float32: the product over blocks of each column's
    growth of the chunk-local paths ``rows``, as the plain and keep-fold
    variants (and the probes under ``ablate``) take it."""
    return _block_product(
        _growth_blocks(q.to(torch.float32), arow, cs, seed_base, tile0,
                       rows, p_tile, ablate), rows.numel(), q.device)


def prefix_growth(q, arow, cs, *, seed_base, tile0, rows):
    """Each block's (len(rows), 128) float32 growth of the chunk-local
    paths ``rows`` in the prefix variant's stream tiles, in block order
    (the rows ``prefix_finish_twin`` finishes)."""
    return _growth_blocks(q.to(torch.float32), arow, cs, seed_base, tile0,
                          rows, CLT_P_STRATEGY)


def finish_sum_twin(terms):
    """Each row's sum of the (paths, 128) float32 ``terms`` in the order of
    ``csrc/clt.cu``'s finish (plain, keep-fold and the probes): lane tig of
    a quad adds its columns nt*8 + 2*tig + e (nt = 0..15, e = 0, 1) in that
    order from 0, then the quad adds the four partial sums as (p0 + p1) +
    (p2 + p3) (two xor shuffles). The plain version sums column by column
    instead; the two orders differ in the last bits."""
    part = []
    for tig in range(4):
        acc = torch.zeros_like(terms[:, 0])
        for nt in range(CLT_K // 8):
            for e in range(2):
                acc = acc + terms[:, nt * 8 + 2 * tig + e]
        part.append(acc)
    return (part[0] + part[1]) + (part[2] + part[3])


def finals_twin(prod, v0, ablate="base"):
    """Finals of the row products ``prod`` as the kernel finishes them:
    v0 * exp(the twin sum of the logs), or, for the nologexp probe,
    (v0 * the twin sum of the products) / 128."""
    v0f = ce._f32(v0)
    if ablate == "nologexp":
        return (v0f * finish_sum_twin(prod)) * (1.0 / CLT_K)
    return v0f * torch.exp(finish_sum_twin(torch.log(prod)))


def _prefix_columns():
    """The month each accumulator column of the prefix kernel holds (its
    staged Q's column order, ``csrc/clt.cu`` ``prefix_column``): lane t of
    a quad holds columns 8nt + 2t + e; in part P = nt // (R / 2) they hold
    months 4 R P + R t + 2 (nt % (R / 2)) + e, R = ``PREFIX_RUN``."""
    run = PREFIX_RUN
    n = np.arange(CLT_K)
    nt = n >> 3
    return torch.as_tensor(4 * run * (nt // (run // 2)) + run * ((n >> 1) & 3)
                           + 2 * (nt % (run // 2)) + (n & 1))


def prefix_scan_twin(y):
    """(paths, 128) exclusive prefix sums along each row of ``y`` (month
    order) in the order of ``csrc/clt.cu``'s ``prefix_block``, in parts of
    4 R months, R = ``PREFIX_RUN``: lane t of a quad holds the part's
    months R t .. R t + R - 1 and sums them in order from 0 (r_t its
    total); the quad's exclusive scan of the totals 0, r0, r0 + r1,
    r0 + (r1 + r2) is added to the row's prefix before the part, which
    then adds the part's (r0 + r1) + (r2 + r3); a month takes its lane's
    base plus the lane's sum before it."""
    run = PREFIX_RUN
    n = y.shape[0]
    lanes = y.reshape(n, CLT_K // (4 * run), 4, run)
    before = torch.empty_like(lanes)
    r = torch.zeros_like(lanes[..., 0])
    for i in range(run):
        before[..., i] = r
        r = r + lanes[..., i]
    s1 = torch.cat([r[..., :1], r[..., :-1] + r[..., 1:]], -1)
    incl = torch.cat([s1[..., :2], s1[..., :-2] + s1[..., 2:]], -1)
    scan = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :3]], -1)
    base = torch.empty_like(scan)
    pre = torch.zeros_like(r[:, 0, 0])
    for part in range(lanes.shape[1]):
        base[:, part] = pre[:, None] + scan[:, part]
        pre = pre + incl[:, part, 3]
    return (base[..., None] + before).reshape(n, CLT_K)


def prefix_finish_twin(blocks, keep, v0):
    """(finals, withdrawn) of the prefix variant as the kernel finishes its
    growth rows: ``blocks`` yields each block's (paths, 128) float32 growth
    in block order (``prefix_growth``), ``keep`` holds the (nblocks, 128)
    keep rows. Per block, y = log(max(g*keep, 1e-37)), excl = exp of
    ``prefix_scan_twin(y)``, the withdrawn sum of (excl*g)*(1-keep), each
    lane's months in its column order, then (s0 + s1) + (s2 + s3)
    (``finish_sum_twin`` over the kernel's column order), and the carry
    times excl*g*keep of month 127. The plain version takes the prefix and
    the sum month by month; the two differ in the last bits of each
    prefix."""
    v0f = ce._f32(v0)
    gk_floor = ce._f32(1e-37)
    cols = None
    carry = wsum = None
    for j, g in enumerate(blocks):
        if carry is None:
            cols = _prefix_columns().to(g.device)
            carry = torch.ones_like(g[:, 0])
            wsum = torch.zeros_like(carry)
        gk = g * keep[j]
        excl = torch.exp(prefix_scan_twin(
            torch.log(torch.clamp_min(gk, gk_floor))))
        s = finish_sum_twin(((excl * g) * (1.0 - keep[j]))[:, cols])
        wsum = wsum + (v0f * carry) * s
        carry = carry * (excl[:, CLT_K - 1] * gk[:, CLT_K - 1])
    return v0f * carry, wsum


def clt_chunk_plain(q, arow, cs, keep, *, variant, seed_base, tile0, valid,
                    n_paths, v0, target, shift, lo, log_lo, inv_w, hb,
                    with_hist, keep_finals):
    """Plain PyTorch version of ``csrc/clt.cu``, in slabs of paths. The
    product is ``torch.matmul`` of the bf16-rounded counts and Q in
    float32; TF32 is switched off (``torch.backends.cuda.matmul.
    allow_tf32 = False``) so that on the card too it runs in full float32.
    Row sums and the prefix run column by column, in the kernel's order."""
    finals, wsum = _finals_plain(q, arow, cs, keep, variant=variant,
                                 seed_base=seed_base, tile0=tile0,
                                 n_paths=n_paths, v0=v0)
    stats, hist = ce._epilogue(finals, wsum, valid, v0, target, shift, lo,
                               log_lo, inv_w, hb, with_hist)
    return stats, hist, (finals[:valid] if keep_finals else None)


def _finals_plain(q, arow, cs, keep, *, variant, seed_base, tile0, n_paths,
                  v0, ablate="base"):
    """(finals, withdrawn-or-None) of ``n_paths`` paths, as
    ``clt_chunk_plain`` and ``clt_probe_chunk_plain`` compute them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = q.device
    p_tile = tile_paths(variant)
    qf = q.to(torch.float32)
    v0f = ce._f32(v0)
    finals = torch.empty((n_paths,), dtype=torch.float32, device=dev)
    wsum = (torch.zeros((n_paths,), dtype=torch.float32, device=dev)
            if variant == "prefix" else None)
    if variant == "prefix":
        omk = 1.0 - keep
        gk_floor = ce._f32(1e-37)
    for s0 in range(0, n_paths, _SLAB):
        s1 = min(s0 + _SLAB, n_paths)
        rows = torch.arange(s0, s1, device=dev)
        blocks = _growth_blocks(qf, arow, cs, seed_base, tile0, rows, p_tile,
                                ablate)
        if variant != "prefix":
            prod = _block_product(blocks, rows.numel(), dev)
            terms = prod if ablate == "nologexp" else torch.log(prod)
            acc = torch.zeros_like(terms[:, 0])
            for c in range(CLT_K):
                acc = acc + terms[:, c]
            finals[s0:s1] = ((v0f * acc) * (1.0 / CLT_K)
                             if ablate == "nologexp" else v0f * torch.exp(acc))
            continue
        carry = torch.ones_like(rows, dtype=torch.float32)
        w = torch.zeros_like(carry)
        for j, g in enumerate(blocks):
            gk = g * keep[j]
            y = torch.log(torch.clamp_min(gk, gk_floor))
            run = torch.zeros_like(carry)
            s = torch.zeros_like(carry)
            for c in range(CLT_K):
                excl = torch.exp(run)
                s = s + excl * g[:, c] * omk[j, c]
                run = run + y[:, c]
            w = w + (v0f * carry) * s
            carry = carry * (excl * gk[:, CLT_K - 1])
        wsum[s0:s1] = w
        finals[s0:s1] = v0f * carry
    return finals, wsum


def clt_launcher(q, arow, cs, keep, *, variant, seed_base, tile0, valid,
                 n_paths, v0, target, shift, lo, log_lo, inv_w, hb,
                 with_hist, keep_finals, blocks_per_sm=None):
    """Checked inputs of one CLT chunk on a CUDA device -> ``(launch,
    outputs)`` (``cuda_engine._prepare``); ``launch()`` is the bare kernel,
    uncounted. ``blocks_per_sm`` caps the grid (the blocks stride over the
    64-path groups; default the variant's own); the results do not depend
    on it."""
    if blocks_per_sm is None:
        blocks_per_sm = (_PREFIX_BLOCKS_PER_SM if variant == "prefix"
                         else _BLOCKS_PER_SM)
    dev = q.device
    ce._check_chunk(dev, "CLT", valid, n_paths)
    ce._check(q, "q", dev, CLT_K * CLT_K, torch.bfloat16)
    nblocks = arow.shape[0] if arow.dim() == 2 else -1
    ce._check(arow, "arow", dev, nblocks * CLT_K)
    ce._check(cs, "cs", dev, nblocks * CLT_K)
    if variant == "prefix":
        ce._check(keep, "keep", dev, nblocks * CLT_K)
    else:
        keep = None
    args = (VARIANTS[variant], ce._ptr(q), ce._ptr(arow), ce._ptr(cs),
            ce._ptr(keep), nblocks, tile_paths(variant),
            int(seed_base) & ce.MASK32, int(tile0) & ce.MASK32, valid,
            ce._f32(v0), ce._f32(np.float32(1.0) / np.float32(v0)),
            ce._f32(target), ce._f32(shift), ce._f32(log_lo),
            ce._f32(inv_w), hb)
    return ce._prepare("smmc_clt", args, dev, valid, lo=lo, log_lo=log_lo,
                       inv_w=inv_w, hb=hb, with_hist=with_hist,
                       keep_finals=keep_finals, rows_per_block=_ROWS,
                       blocks_per_sm=blocks_per_sm)


def clt_chunk(q, arow, cs, keep, **kw):
    """One chunk of the CLT sampler.

    ``q``: bfloat16 (128, 128) (``q_tensor``); ``arow``/``cs``: float32
    (nblocks, 128) (``block_consts``); ``keep``: float32 (nblocks, 128)
    keep rows (``keep_rows``), read by the prefix variant only (None
    otherwise). Keywords as ``clt_chunk_plain``: ``seed_base`` is the CLT
    stream's base (already XOR-ed with ``CLT_STREAM_XOR``) and ``tile0``
    the first CLT tile (path offset // ``tile_paths(variant)``). Returns
    (stats, hist, finals-or-None) on ``q.device``, the chunk contract of
    ``cuda_engine``."""
    if q.device.type == "cpu":
        return clt_chunk_plain(q, arow, cs, keep, **kw)
    return ce._launch_counted("clt", clt_launcher(q, arow, cs, keep, **kw))


# ---------------------------------------------------------------------------
# Probe instances: the ablation and the tile grouping.
# ---------------------------------------------------------------------------


def _check_probe(ablate, tiles_per_block):
    if ablate not in ABLATIONS:
        raise ValueError(f"unknown ablation {ablate!r}")
    if tiles_per_block not in GROUPINGS:
        raise ValueError(f"tiles_per_block must be one of {GROUPINGS}, got "
                         f"{tiles_per_block}")


def clt_probe_chunk_plain(q, arow, cs, *, ablate, tiles_per_block=0,
                          seed_base, tile0, valid, n_paths, v0, target, lo,
                          log_lo, inv_w, hb, with_hist, keep_finals):
    """Plain PyTorch version of the probe instances: the plain variant
    with ``ablate`` applied (``nohist`` leaves the histogram at zeros) and
    the raw stats, float64. ``tiles_per_block`` changes no value here; on
    the card it regroups the float64 power sums."""
    _check_probe(ablate, tiles_per_block)
    finals, _ = _finals_plain(q, arow, cs, None, variant="plain",
                              seed_base=seed_base, tile0=tile0,
                              n_paths=n_paths, v0=v0, ablate=ablate)
    stats, hist = ce._epilogue(finals, None, valid, 1.0, target, 0.0, lo,
                               log_lo, inv_w, hb,
                               with_hist and ablate != "nohist",
                               stats_dtype=torch.float64)
    return stats, hist, (finals[:valid] if keep_finals else None)


def clt_probe_launcher(q, arow, cs, *, ablate, tiles_per_block=0, seed_base,
                       tile0, valid, n_paths, v0, target, lo, log_lo, inv_w,
                       hb, with_hist, keep_finals):
    """Checked inputs of one probe chunk on a CUDA device -> ``(launch,
    outputs)``, as ``clt_launcher``; inv0 = 1 and shift = 0 give the raw
    sums. The histogram must bin in place (``in_kernel_hist``)."""
    _check_probe(ablate, tiles_per_block)
    dev = q.device
    ce._check_chunk(dev, "CLT probe", valid, n_paths)
    ce._check(q, "q", dev, CLT_K * CLT_K, torch.bfloat16)
    nblocks = arow.shape[0] if arow.dim() == 2 else -1
    ce._check(arow, "arow", dev, nblocks * CLT_K)
    ce._check(cs, "cs", dev, nblocks * CLT_K)
    if with_hist and not ce.in_kernel_hist(hb, with_hist):
        raise ValueError(f"the probe bins in place: {hb} cells is not a "
                         f"multiple of 64 up to {ce.KERNEL_HIST_CELLS}")
    n_blocks = None
    if tiles_per_block:
        n_blocks = -(-(-(-valid // CLT_P)) // tiles_per_block)
    args = (ABLATIONS[ablate], tiles_per_block, ce._ptr(q), ce._ptr(arow),
            ce._ptr(cs), nblocks, CLT_P, int(seed_base) & ce.MASK32,
            int(tile0) & ce.MASK32, valid, ce._f32(v0), 1.0,
            ce._f32(target), 0.0, ce._f32(log_lo), ce._f32(inv_w), hb)
    return ce._prepare("smmc_clt_probe", args, dev, valid, lo=lo,
                       log_lo=log_lo, inv_w=inv_w, hb=hb,
                       with_hist=with_hist, keep_finals=keep_finals,
                       rows_per_block=_ROWS, blocks_per_sm=_BLOCKS_PER_SM,
                       n_blocks=n_blocks, stats_dtype=torch.float64)


def clt_probe_chunk(q, arow, cs, **kw):
    """One chunk of a probe instance of the plain variant (``ablate``, one
    of ``ABLATIONS``; ``tiles_per_block``, one of ``GROUPINGS``): (stats
    float64, hist, finals-or-None) on ``q.device``, keywords as
    ``clt_chunk``'s without ``variant`` and ``shift``. Counts its launch
    under ``clt_probe_<ablate>`` at 0 tiles a block, else under
    ``clt_probe_ts<tiles_per_block>``."""
    if q.device.type == "cpu":
        return clt_probe_chunk_plain(q, arow, cs, **kw)
    ts = kw.get("tiles_per_block", 0)
    return ce._launch_counted(
        f"clt_probe_ts{ts}" if ts else f"clt_probe_{kw['ablate']}",
        clt_probe_launcher(q, arow, cs, **kw))
