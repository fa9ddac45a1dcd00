"""Byte planes of the counter stream: a hand-written CUDA kernel
(``csrc/byte_planes.cu``) and its plain PyTorch version.

Counterpart of the one kernel body of ``experiments/exp_prng_bytes.py:19``
and ``experiments/exp_prng_crossword.py:26`` (``pl.pallas_call`` at :34
and :41): seed the generator with a raw seed, draw one (1024, 128) block
of 32-bit words and write its four bytes as float32 planes (4 * 1024, 128),
plane b = (w >> 8b) & 0xFF. The TPU kernel draws the hardware PRNG; the
port draws its counter stream from the same seed, key 0:
``_arith_bits(seed, 0, (1024, 128))``, the word ``arith_word(
tile_seed(seed, 0), r * 128 + c)``, the stream ``clt.cu`` draws its counts
from.

``byte_planes`` runs its plain version only when asked for
``device="cpu"``; on a CUDA device it launches the kernel or raises.
Launches count under ``cuda_engine.LAUNCHES["byte_planes"]``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stock_market_monte_carlo_torch.ops import cuda_engine as ce

ROWS, LANES = 1024, 128          # the experiments' (P, K)
WORDS = ROWS * LANES
# the experiments' seeds: exp_prng_bytes.py (8) and exp_prng_crossword.py
# (16)
BYTES_SEEDS = tuple(s * 7919 + 13 for s in range(8))
CROSSWORD_SEEDS = tuple(s * 104729 + 7 for s in range(16))


def _check(seeds):
    if not 1 <= len(seeds) <= 65535:
        raise ValueError(f"1 to 65535 seeds, got {len(seeds)}")


def byte_planes_plain(seeds, device="cpu"):
    """Plain PyTorch version on ``device``: (len(seeds), 4 * 1024, 128)
    float32, the planes of each seed's draw."""
    _check(seeds)
    dev = torch.device(device)
    s = torch.as_tensor(np.asarray(seeds, np.int64) & ce.MASK32,
                        device=dev)[:, None]
    w = ce._arith_bits(s, 0, torch.arange(WORDS, device=dev)[None, :])
    planes = torch.stack([(w >> (8 * b)) & 0xFF for b in range(4)], dim=1)
    return planes.to(torch.float32).reshape(len(seeds), 4 * ROWS, LANES)


def byte_planes_launcher(seeds, device="cuda"):
    """Checked inputs on a CUDA device -> ``(launch, outputs)``:
    ``launch()`` runs the kernel, uncounted; ``outputs()`` returns the
    planes."""
    from stock_market_monte_carlo_torch.ops._build import load_library

    _check(seeds)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no byte-planes kernel for device {dev}")
    words = np.asarray(seeds, np.int64).astype(np.uint32).view(np.int32)
    seeds_t = torch.as_tensor(words).to(dev)
    out = torch.empty((len(seeds), 4 * ROWS, LANES), dtype=torch.float32,
                      device=dev)
    args = (ce._ptr(seeds_t), len(seeds), ce._ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    fn = load_library().smmc_byte_planes

    def launch(held=(seeds_t, out)):  # for the kernel
        ce._raise_on(fn(*args), "smmc_byte_planes")

    return launch, lambda: out


def byte_planes(seeds, device="cuda"):
    """The byte planes of each seed's draw: (len(seeds), 4 * 1024, 128)
    float32 on ``device``. Counts its launch under ``byte_planes``."""
    if torch.device(device).type == "cpu":
        return byte_planes_plain(seeds)
    return ce._launch_counted("byte_planes",
                              byte_planes_launcher(seeds, device))
