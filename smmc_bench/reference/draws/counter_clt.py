"""The CLT Gaussian draw (the port's ``gaussian_sampler`` "clt-prefix"):
each month's z is a weighted sum of 128 uniform 16-bit counts, mixed
through the vendored orthogonal matrix Q (``data/clt_q128.npy``) and
centred and scaled by exact per-column constants. Written from the
stream's contract, as ``stock_market_monte_carlo_torch/ops/clt.py``
states it (its module docstring, ``clt_qmatrix``, ``block_consts``, at
commit 1e5784e); nothing here imports the port.

The stream:

- base ``stream.seed_base(seed) ^ 0x11C7``; stream tiles of 2048 paths,
  indexed by the global path // 2048;
- block j (months 128 j .. 128 j + 127) of tile T draws, for the tile's
  path p and column c, the word ``finalize((tile_seed(tile_seed(base,
  T), j) + mul32(p * 128 + c, GOLDEN)) & MASK32)``; its count is the
  word's top 16 bits rounded to bfloat16 (to nearest even);
- month t = 128 j + c: z_raw = (the path's counts of block j) @ Q,
  column c, in float32; growth = (a - colshift_c b) + z_raw (colscale_c
  b), a and b from ``stream.gaussian_ab``, colscale and colshift in
  float64 from Q's bfloat16 values, rounded to float32.

Departures from the kernel's arithmetic (``csrc/clt.cu``, ``kPrefix``),
which the cell's limits absorb:

- the product: here the float32 matrix product of torch (TF32 off), in
  the BLAS's order; the kernel sums in its ``wgmma`` accumulators'
  order;
- the compounding and the withdrawn total: ``paths.Run.months`` steps V
  * g, then * keep, month by month in float32 and adds each month's
  withdrawn amount; the kernel takes each 128-month block's log-space
  exclusive prefix (the logs of g * keep summed in runs of 8 months and
  scanned over a quad of lanes, then ``exp``), the block's withdrawn sum
  in its column order, and one carry a block. The same function,
  rounded otherwise.

Each block's growth is made once, for every path of the reference's
block of tiles, in slabs of ``SLAB`` paths.
"""

from __future__ import annotations

import hashlib
import io
from pathlib import Path

import numpy as np
import torch

from smmc_bench.reference import stream

STREAM_XOR = 0x11C7
TILE = 2048      # paths of a stream tile
K = 128          # months of a block: Q's side
SLAB = 1 << 18   # paths of one product
Q_SHA256 = "b8f8958ee25e0a8a4c30671c945a3d87cb71a666292d0ae5dee9353161e36907"
Q_PATH = Path(__file__).resolve().parents[2] / "data" / "clt_q128.npy"


def qmatrix():
    """(q, colscale, colshift): Q's bfloat16 values as a float32 (128,
    128) tensor (counts in, months out), and the float32 (128,) constants
    of z_c = (counts @ Q)_c colscale_c - colshift_c, which give z mean 0
    and variance 1 for counts uniform over [0, 2^16)."""
    raw = Q_PATH.read_bytes()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != Q_SHA256:
        raise RuntimeError(f"{Q_PATH} sha256 {digest}, expected {Q_SHA256}")
    bits = np.load(io.BytesIO(raw))
    q = torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).to(torch.float32)
    q64 = q.to(torch.float64).numpy()
    colnorm = np.sqrt((q64 ** 2).sum(axis=0))
    s_corr = np.sqrt(12.0 / (1.0 - 2.0**-32))
    colscale = (2.0**-16 * s_corr / colnorm).astype(np.float32)
    colshift = (32767.5 * 2.0**-16 * s_corr * q64.sum(axis=0)
                / colnorm).astype(np.float32)
    return q, colscale, colshift


def growth_fn(model, table, base, tile0, n_tiles, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    a, b = (np.float32(v) for v in stream.gaussian_ab(
        model["args"]["mean_pct"], model["args"]["std_pct"]))
    q, colscale, colshift = qmatrix()
    q = q.to(dev)
    arow = torch.as_tensor(a - colshift * b, device=dev)
    cs = torch.as_tensor(colscale * b, device=dev)
    n = n_tiles * stream.TILE_PATHS
    path = int(tile0) * stream.TILE_PATHS + torch.arange(n, device=dev)
    keys = stream.tile_seed((int(base) ^ STREAM_XOR) & stream.MASK32,
                            (path // TILE) & stream.MASK32)
    col = torch.arange(K, device=dev)
    held = {}

    def block(j):
        """(128, n) float32 growth of block j's months, month-major."""
        out = torch.empty((K, n), dtype=torch.float32, device=dev)
        keys_j = stream.tile_seed(keys, j)
        for s0 in range(0, n, SLAB):
            s1 = min(s0 + SLAB, n)
            pos = stream.mul32((path[s0:s1, None] % TILE) * K + col,
                               stream._GOLDEN)
            words = stream.finalize((keys_j[s0:s1, None] + pos)
                                    & stream.MASK32)
            counts = (words >> 16).to(torch.float32).to(torch.bfloat16).to(
                torch.float32)
            out[:, s0:s1] = (arow + (counts @ q) * cs).T
        return out

    def growth(t):
        j = t // K
        if held.get("j") != j:
            held.clear()
            held.update(j=j, g=block(j))
        return held["g"][t % K].reshape(n_tiles, stream.TILE_ROWS, 128)
    return growth
