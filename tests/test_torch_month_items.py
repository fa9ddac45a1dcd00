"""The historical month loop's warp items (``csrc/month_loop.cu``) in
their CPU twins: the chunk paths the warps take
(``cuda_engine.historical_item_paths``) and the draw of an item's paths
from its staged words (``cuda_engine.historical_item_growth``).

A warp owns items of 256 consecutive chunk paths, two 128-path rows of an
8192-path RNG tile; lane l holds paths item0 + l + 32 i, i < 8, the row's
lane-0 word comes by shuffle and the source lane's word from the item's
words in shared memory. The coverage holds at ragged ``valid`` (partial
items) and at the grids the wrapper launches (``_launch_geometry`` at 4,
8 and 16 blocks a SM of a 132-SM card, and a single block); the draw
equals the plain version's sliced rotation (``_sliced_rotation_draw``) bit
for bit on the three card-test tables.
"""

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_torch.data.loader import (
    HOSTILE_CSV,
    SYNTHETIC_CSV,
    read_historical_returns,
)
from stock_market_monte_carlo_torch.ops import cuda_engine as ce

SMS = 132


def _grid(valid, blocks_per_sm):
    return ce._launch_geometry(SMS, valid, ce._BLOCK
                               * ce.HISTORICAL_LANE_PATHS, blocks_per_sm)


@pytest.mark.parametrize("valid", [1, 255, 256, 257, 8191,
                                   2 * 8192 + 1001, 1 << 20, 100_000_000
                                   - 5 * (1 << 24)])
@pytest.mark.parametrize("blocks_per_sm", [None, 4, 8, 16])
def test_items_cover_every_path_once(valid, blocks_per_sm):
    """blocks_per_sm None: one block for the whole chunk."""
    n_blocks = 1 if blocks_per_sm is None else _grid(valid, blocks_per_sm)
    paths, live = ce.historical_item_paths(valid, n_blocks)
    got = paths[live]
    assert got.numel() == valid
    assert torch.equal(torch.sort(got).values, torch.arange(valid))
    # a lane's paths lie in its item, and an item in one RNG tile and two
    # of its rows
    item0 = paths[..., :1, :1] - paths[..., :1, :1] % ce.HISTORICAL_ITEM_PATHS
    assert bool(((paths - item0 >= 0)
                 & (paths - item0 < ce.HISTORICAL_ITEM_PATHS)).all())
    assert bool((paths // ce.TILE_PATHS == item0 // ce.TILE_PATHS).all())
    lane = torch.arange(32)[:, None]
    i = torch.arange(ce.HISTORICAL_LANE_PATHS)
    assert bool((paths % 128 == lane + 32 * (i % 4)).all())
    assert bool(((paths - item0) // 128 == i // 4).all())


@pytest.mark.parametrize("tile0", [0, 37, (1 << 19) - 1])
def test_item_tiles_and_positions(tile0):
    """The stream key and position of each covered path as the kernel
    forms them from its item's first path p0 (tile tile0 + (p0 >> 13),
    position (p0 & 8191) + lane + 32 i, uint32) are the plain version's
    (tile tile0 + p // 8192, position p % 8192), also where the global
    ids tile0 * 8192 + p wrap at 2^32 (tile0 = 2^19 - 1)."""
    valid = 2 * 8192 + 1001
    paths, live = ce.historical_item_paths(valid, 3)
    p0 = paths[..., :1, :1] - paths[..., :1, :1] % ce.HISTORICAL_ITEM_PATHS
    lane = torch.arange(32)[:, None]
    i = torch.arange(ce.HISTORICAL_LANE_PATHS)
    tile = ((tile0 + (p0 >> 13)) & ce.MASK32).expand(paths.shape)[live]
    pos = ((p0 & (ce.TILE_PATHS - 1)) + lane + 32 * i)[live]
    p = paths[live]
    assert torch.equal(tile, (tile0 + p // ce.TILE_PATHS) & ce.MASK32)
    assert torch.equal(pos, p % ce.TILE_PATHS)


def _table(name):
    if name == "n1127":
        return read_historical_returns(SYNTHETIC_CSV)
    if name == "hostile_n97":
        return read_historical_returns(HOSTILE_CSV)
    return np.random.default_rng(3).uniform(-6.0, 6.5, 20000).astype(
        np.float32)


@pytest.mark.parametrize("table_name", ["n1127", "hostile_n97", "n20000"])
def test_item_growth_is_the_sliced_rotation(table_name):
    flat, n = ce._pad_table(_table(table_name))
    table = torch.as_tensor(flat)
    k_chunks = table.numel() // 128
    tail_n = n - 128 * (k_chunks - 1)
    n_valid = torch.where(torch.arange(128) < tail_n, k_chunks, k_chunks - 1)
    words = torch.as_tensor(np.random.default_rng(n).integers(
        0, 1 << 32, (3, ce.TILE_ROWS, 128), dtype=np.int64))
    words[0, :, 0] = 0                      # rotation 0 at every row
    words[1, :, 0] = (1 << 32) - 1          # rotation 127
    want = ce._sliced_rotation_draw(table.reshape(k_chunks, 128), n_valid,
                                    n, tail_n, words)
    got = ce.historical_item_growth(
        table, n, words.reshape(-1, ce.HISTORICAL_ITEM_PATHS))
    assert torch.equal(got.reshape(want.shape), want)
