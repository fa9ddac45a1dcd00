"""Paths compounded month by month, and the statistics and per-month
counts a query returns, computed in plain PyTorch from the stream.

The compounding and strategy step is a frozen copy of
``month_loop_chunk_plain`` (``stock_market_monte_carlo_torch/ops/
cuda_engine.py``) and ``_month_values`` (``ops/bands.py``) at commit
b0a87fd; the bin of a final value is ``_kernel_bin_indices`` (the
chunk kernels' in-place binning of a 4096-cell histogram) with
``torch.log``; a month's band cell is ``hist_cells``, its counts below
thresholds ``cdf_thresholds`` and a strict compare. The statistics are
taken in float64 straight from the paths' values, in blocks of tiles of
any size: the stream of a path depends only on its global tile. Nothing
here imports the port.

``dtype`` is the precision of the values and growth factors: float32 as
the configurations state, or bfloat16 for the control.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from smmc_bench.reference import analytics
from smmc_bench.reference import stream

# tiles a block: 2^24 paths, the port's chunk
BLOCK_TILES = 2048


def _blocks(n_paths: int):
    """(tile0, n_tiles, valid) of each block of a run of ``n_paths``."""
    n_tiles = -(-n_paths // stream.TILE_PATHS)
    for tile0 in range(0, n_tiles, BLOCK_TILES):
        tiles = min(BLOCK_TILES, n_tiles - tile0)
        valid = min(n_paths - tile0 * stream.TILE_PATHS,
                    tiles * stream.TILE_PATHS)
        yield tile0, tiles, valid


class Run:
    """One query's inputs: the configuration, the traffic mix, the table
    and the seed, on ``device`` in ``dtype``."""

    def __init__(self, config, traffic, table, seed, device,
                 dtype=torch.float32):
        self.model = dict(config["model"])
        self.table_np = None if table is None else np.asarray(table,
                                                              np.float32)
        self.n_paths = int(config["n_paths"])
        self.n_periods = int(config["n_periods"])
        self.v0 = float(config["initial_capital"])
        self.traffic = traffic
        self.strategy = traffic.get("strategy", {"kind": "none"})
        self.base = stream.seed_base(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self.table = None
        if self.table_np is not None:
            flat, self.model["n_table"] = stream.pad_table(self.table_np)
            self.table = torch.as_tensor(flat, device=self.device)
        self.draw = importlib.import_module(
            f"smmc_bench.reference.draws.{self.model['draw']}")
        keep = analytics.keep_factors(self.strategy, self.n_periods)
        self.keep = (None if keep is None
                     else torch.as_tensor(keep, device=self.device))

    def months(self, tile0, n_tiles, valid, fold_keep=False):
        """Yields (t, values, withdrawn): the block's first ``valid``
        paths' values after month t+1 as float32 (valid,), and their
        running withdrawn totals (None without a withdrawal). The stats
        kernels step V * g, then * keep; the band kernels fold the keep
        into the growth first (``fold_keep``): V * (g * keep)."""
        growth = self.draw.growth_fn(self.model, self.table, self.base,
                                     tile0, n_tiles, self.device)
        total = torch.full((n_tiles, stream.TILE_ROWS, 128),
                           stream.f32(self.v0), dtype=self.dtype,
                           device=self.device)
        wsum = None if self.keep is None else torch.zeros_like(total)
        keep = None if self.keep is None else self.keep.to(self.dtype)
        for t in range(self.n_periods):
            g = growth(t).to(self.dtype)
            if fold_keep and keep is not None:
                total = total * (g * keep[t])
                yield t, total.reshape(-1)[:valid].float(), None
                continue
            grown = total * g
            if keep is None:
                total = grown
            else:
                total = grown * keep[t]
                wsum = wsum + (grown - total)
            yield (t, total.reshape(-1)[:valid].float(),
                   None if wsum is None
                   else wsum.reshape(-1)[:valid].float())

    def finals(self, tile0, n_tiles, valid):
        """(finals, withdrawn) of a block after the last month."""
        for _, values, wsum in self.months(tile0, n_tiles, valid):
            pass
        return values, wsum

    def stats(self) -> dict:
        """The query's statistics: n, mean, std, min, max, count below the
        target, total withdrawn, and the final values' histogram."""
        cells = int(self.traffic["options"]["histogram_bins"]) + 2
        spec = analytics.histogram_spec(self.model, self.table_np,
                                        self.strategy, self.n_periods,
                                        self.v0, cells - 2)
        log_lo, inv_w = stream.f32(spec.log_lo), stream.f32(1.0 / spec.width)
        target = stream.f32(self.traffic["call"]["target_amount"])
        dev = self.device
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        s1 = s2 = wd = zero
        n, below, shift = 0, 0, None
        lo, hi = float("inf"), float("-inf")
        hist = torch.zeros((cells,), dtype=torch.int64, device=dev)
        for tile0, n_tiles, valid in _blocks(self.n_paths):
            f, w = self.finals(tile0, n_tiles, valid)
            d = f.double()
            if shift is None:
                shift = d.mean()
            d = d - shift
            s1, s2 = s1 + d.sum(), s2 + (d * d).sum()
            if w is not None:
                wd = wd + w.double().sum()
            n += valid
            below += int((f < target).sum())
            lo, hi = min(lo, float(f.min())), max(hi, float(f.max()))
            logv = torch.log(torch.clamp_min(f, 1e-37))
            x = torch.floor((logv - log_lo) * inv_w)
            bins = torch.clamp(x, 0.0, float(cells - 2)).to(torch.int64) + 1
            bins = torch.where(logv < log_lo, 0, bins)
            hist += torch.bincount(bins, minlength=cells)
        m1, m2 = float(s1) / n, float(s2) / n
        return dict(n=n, mean=float(shift) + m1,
                    std=float(np.sqrt(max(m2 - m1 * m1, 0.0))), min=lo,
                    max=hi, count_below=below, withdrawn=float(wd),
                    hist=hist.cpu().numpy().astype(np.float64))

    def month_counts(self) -> np.ndarray:
        """(T+1, cells) per-month counts of the bands: the histogram of
        each month's values on its z-grid (``band_mode`` "hist"), or the
        counts below each month's thresholds ("cdf"); month 0 is every
        path at v0."""
        tr = self.traffic["call"]
        centers, scales = analytics.band_grid(
            self.model, self.table_np, self.strategy, self.n_periods,
            self.v0)
        dev, t_n = self.device, self.n_periods
        if tr["band_mode"] == "hist":
            n_bins = int(tr["n_bins"])
            cells = n_bins + 2
            coef_a, coef_b, idx0 = analytics.hist_coefficients(
                centers, scales, n_bins, self.v0)
            row0 = np.zeros((cells,))
            row0[idx0] = self.n_paths
        else:
            cells = int(tr["n_thresholds"])
            coef_a, coef_b, kap_lo, kap_hi, _, m0row = \
                analytics.cdf_coefficients(centers, scales, cells, self.v0)
            row0 = self.n_paths * m0row
            kk = torch.arange(cells, dtype=torch.float32, device=dev)
            kk[0], kk[-1] = stream.f32(kap_lo), stream.f32(kap_hi)
            thr = torch.exp(torch.as_tensor(coef_a, device=dev)[:, None]
                            + kk[None, :]
                            * torch.as_tensor(coef_b, device=dev)[:, None])
        a_t = torch.as_tensor(coef_a, device=dev)
        b_t = torch.as_tensor(coef_b, device=dev)
        tiny = torch.full((), stream.f32(1e-37), device=dev)
        counts = torch.zeros((t_n, cells), dtype=torch.int64, device=dev)
        for tile0, n_tiles, valid in _blocks(self.n_paths):
            for t, v, _ in self.months(tile0, n_tiles, valid,
                                           fold_keep=True):
                if tr["band_mode"] == "hist":
                    x = torch.floor(torch.log(torch.fmax(v, tiny)) * a_t[t]
                                    + b_t[t])
                    idx = torch.clamp(x, -1.0, float(cells - 2)).to(
                        torch.int64) + 1
                    counts[t] += torch.bincount(idx, minlength=cells)
                else:
                    # thresholds ascend along k: v < thr[k] for every k at
                    # or past the number of thresholds not above v
                    j = torch.searchsorted(thr[t].contiguous(), v,
                                           right=True)
                    counts[t] += torch.cumsum(torch.bincount(
                        j, minlength=cells + 1), 0)[:cells]
        return np.concatenate([row0[None, :],
                               counts.cpu().numpy().astype(np.float64)])
