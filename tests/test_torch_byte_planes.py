"""The counter stream's byte planes (``ops/byte_planes.py``) against the
one kernel body of ``experiments/exp_prng_bytes.py`` and
``exp_prng_crossword.py``, on the CPU, and the reports' host statistics.

Both files assert a TPU backend and run at import, so ``kern`` and the
constants it reads are compiled out of each file's syntax tree
(``test_torch_histogram._experiment``) and run under ``pl.pallas_call`` in
interpret mode with the files' specs, at P = 1024, for the first two seeds
of each file; the hardware PRNG is the counter stream (``prng_seed``
stashes the raw seed, ``prng_random_bits`` returns
``pallas_engine._arith_bits(seed, 0, shape)``), through ``monkeypatch``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_torch.bench import probes, roofline
from stock_market_monte_carlo_torch.ops import byte_planes as bp
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_tpu.ops import pallas_engine as pe
from test_torch_histogram import _experiment

FILES = {"exp_prng_bytes": bp.BYTES_SEEDS[:2],
         "exp_prng_crossword": bp.CROSSWORD_SEEDS[:2]}


@pytest.fixture
def stream(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    state = {}

    def prng_seed(seed):
        state["seed"] = seed

    def prng_random_bits(shape):
        return pe._arith_bits(state["seed"], jnp.int32(0), shape)

    monkeypatch.setattr(pltpu, "prng_seed", prng_seed)
    monkeypatch.setattr(pltpu, "prng_random_bits", prng_random_bits)


def _jax_planes(name, seeds):
    """The file's ``kern`` under its pallas_call specs, one call a seed."""
    ns = _experiment(name, {}, ("kern",), consts=("P", "K"))
    p, k = ns["P"], ns["K"]
    call = jax.jit(pl.pallas_call(
        ns["kern"], in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((4 * p, k), jnp.float32)))
    return np.stack([np.asarray(call(jnp.asarray([s], jnp.int32)))
                     for s in seeds])


@pytest.mark.parametrize("name", sorted(FILES))
def test_byte_planes_match_the_experiments(stream, name):
    """Bit for bit, the file's first two seeds; the planes are the bytes of
    the counter word of key 0 at r * 128 + c."""
    seeds = FILES[name]
    want = _jax_planes(name, seeds)
    got = bp.byte_planes(seeds, device="cpu").numpy()
    assert got.shape == want.shape == (2, 4 * bp.ROWS, bp.LANES)
    np.testing.assert_array_equal(got, want)
    w = ce._arith_bits(seeds[1], 0, torch.arange(bp.WORDS)).numpy()
    for b in range(4):
        np.testing.assert_array_equal(
            got[1, b * bp.ROWS:(b + 1) * bp.ROWS].reshape(-1),
            (w >> (8 * b)) & 0xFF)


@pytest.mark.parametrize("name,stats", [
    ("exp_prng_bytes", probes.byte_stats),
    ("exp_prng_crossword", probes.crossword_stats)])
def test_report_statistics_agree_on_both_planes(stream, name, stats):
    """The reports' host statistics of the JAX planes and of the port's:
    equal (the planes are), and of the expected shape."""
    seeds = FILES[name]
    want = stats(_jax_planes(name, seeds))
    got = stats(bp.byte_planes(seeds, device="cpu").numpy())
    assert got == want
    if name == "exp_prng_bytes":
        assert got["n_words"] == 2 * bp.WORDS
        assert all(abs(m - 127.5) < 1.0 for m in got["byte_means"])
        off = np.asarray(got["byte_corr"]) - np.eye(4)
        assert np.abs(off).max() < 0.02          # 2.6e5 words: sd 2e-3
    else:
        # bytes through constants made for 16-bit counts: Var(S) near
        # 2^-16 of 360 (crossword_stats' docstring)
        assert got["n_paths"] == 2 * bp.ROWS
        assert 0.5 < got["var_s_over_360"] * 2.0**16 < 2.0


def test_byte_planes_checks_and_bound():
    """Seeds past int32 wrap as uint32 words; the bound of 8 seeds is their
    16 MiB of planes at 3.35 TB/s."""
    ce.reset_launch_counts()
    a = bp.byte_planes([(1 << 32) + 5], device="cpu")
    assert torch.equal(a, bp.byte_planes_plain([5]))
    assert ce.LAUNCHES["byte_planes"] == 0
    with pytest.raises(ValueError, match="seeds"):
        bp.byte_planes_plain([])
    ms, by, w = roofline.bound("byte_planes", (bp.BYTES_SEEDS,), {})
    assert by == "bytes" and w["bytes"] == 8 * 4 * bp.WORDS * 4 + 8 * 4
    assert ms == pytest.approx(w["bytes"] / 3.35e12 * 1e3)
