"""The counter stream's sliced-rotation bootstrap: frozen copy of
``_sliced_rotation_draw`` and the historical branch of ``month_growth``
(``stock_market_monte_carlo_torch/ops/cuda_engine.py``, commit b0a87fd).

Lane s of a 128-path row is the source of chunk idx(w_s * n mod 2^32,
n_valid[s]); lane l takes column idx(w_l, n) inside the table's last
128-row chunk (the tail), else the row rotation (l + (w_0 & 127)) & 127;
its growth is the table's entry at that column of the column's source
chunk."""

import torch

from smmc_bench.reference.stream import MASK32, idx_exact, month_words


def growth_fn(model, table, base, tile0, n_tiles, device):
    n = int(model["n_table"])
    k_chunks = table.numel() // 128
    tail_n = n - 128 * (k_chunks - 1)
    flat = table.reshape(-1)
    lane = torch.arange(128, device=device)
    n_valid = torch.where(lane < tail_n, k_chunks, k_chunks - 1)
    words = month_words(base, tile0, n_tiles, device)

    def growth(t):
        w = words(t)
        comb = flat[idx_exact((w * n) & MASK32, n_valid) * 128 + lane]
        idx_dest = idx_exact(w, n)
        w_rot = (lane + (w[..., 0:1] & 127)) & 127
        return torch.gather(comb, -1, torch.where(idx_dest < tail_n,
                                                  idx_dest, w_rot))
    return growth
