"""Large and odd histograms: the port's engine against the JAX package on
the CPU, at ``histogram_bins`` past the chunk kernels' in-place 4096 cells
(20000), at a count whose cells are not a multiple of 64 (3998, 4000
cells), and at the default (4094, 4096 cells, binned in place).

The JAX side runs as ``tests/test_torch_engine.py`` runs it: the
arithmetic counter stream (``SMMC_PRNG_IMPL=arith``) and the Pallas
kernels in interpret mode with 8192-path chunks; off the 64x64 in-kernel
histogram it bins the finals in an XLA epilogue with
``HistogramSpec.bin_index``. The port runs its plain versions
(``device="cpu"``), which bin those finals with
``histogram.spec_bin_indices``. Both get the same inputs.

The counts are exact but where a final lies within a rounding of a cell
edge: XLA's and torch's float32 log differ by an ulp now and then, and the
law's and the CLT's finals differ from XLA's within their bars (ROADMAP
queue 3); such a final may move one cell.
"""

import functools

import numpy as np
import pytest
import torch

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions

N = 8192 + 777
T = 12
# the finals' bars against XLA on the CPU (tests/test_torch_engine.py,
# tests/test_torch_gaussian.py); the month loop's finals are bit-exact
FINALS_REL = {"month_loop": 0.0, "law": 2e-6, "clt": 5e-6}
# a float32 log is within an ulp (< 1e-6 at these values' logs) of the
# other's
LOG_ULP = 1e-6
SAMPLERS = {
    "month_loop": ("historical", {}),
    "law": ("historical", dict(terminal_law=True)),
    "clt": ("gaussian", dict(gaussian_sampler="clt")),
}


def _model(kind):
    return (smmc.HistoricalBootstrap.from_csv() if kind == "historical"
            else smmc.GaussianReturns())


@functools.lru_cache(maxsize=None)
def _jax_run(sampler, bins):
    """The JAX package's run (cached: each configuration compiles its
    interpret-mode kernels once). Sets SMMC_PRNG_IMPL itself, restoring
    it after."""
    import os

    kind, opts = SAMPLERS[sampler]
    old = os.environ.get("SMMC_PRNG_IMPL")
    os.environ["SMMC_PRNG_IMPL"] = "arith"
    try:
        return smmc.simulate_stats(
            _model(kind), N, T, seed=3, target_amount=1000.0,
            keep_final_values=True, options=JaxOptions(
                backend="pallas", chunk_paths=8192, histogram_bins=bins,
                **opts))
    finally:
        if old is None:
            del os.environ["SMMC_PRNG_IMPL"]
        else:
            os.environ["SMMC_PRNG_IMPL"] = old


def _port_run(sampler, bins):
    kind, opts = SAMPLERS[sampler]
    return smt.simulate_stats(
        from_reference(_model(kind)), N, T, seed=3, target_amount=1000.0,
        keep_final_values=True, options=smt.EngineOptions(
            device="cpu", chunk_paths=8192, histogram_bins=bins, **opts))


def _near_edges(finals, spec, rel):
    """Finals whose log lies within ``rel`` + an ulp of a cell edge."""
    x = (np.log(finals.astype(np.float64)) - spec.log_lo) / spec.width
    return int(np.sum(np.abs(x - np.round(x)) * spec.width
                      <= rel + LOG_ULP))


@pytest.mark.parametrize("bins", [20000, 3998, 4094])
@pytest.mark.parametrize("sampler", ["month_loop", "law", "clt"])
def test_histogram_bins_match_jax(sampler, bins):
    got, want = _port_run(sampler, bins), _jax_run(sampler, bins)
    rel = FINALS_REL[sampler]
    np.testing.assert_allclose(got.final_values, want.final_values,
                               rtol=rel, atol=0)
    spec, jspec = got.histogram_spec, want.histogram_spec
    assert (spec.lo, spec.hi, spec.n_bins) == (jspec.lo, jspec.hi,
                                               jspec.n_bins)
    hk, hj = got.histogram_counts, np.asarray(want.histogram_counts)
    assert hk.shape == hj.shape == (bins + 2,)
    assert hk.sum() == hj.sum() == N
    moved = np.abs(hk - hj).sum()
    assert moved <= 2 * _near_edges(got.final_values, spec, rel)
    if sampler == "month_loop":
        # bit-exact finals: only a log ulp at an edge moves a count
        assert moved <= 4


@pytest.mark.parametrize("sampler", ["month_loop", "law", "clt"])
def test_default_bins_route_is_unchanged(sampler):
    """The 4096-cell default still bins in place: the port's histogram is
    the kernel binning of its finals, not the spec's."""
    got = _port_run(sampler, 4094)
    spec = got.histogram_spec
    f = got.final_values
    bins = ce._kernel_bin_indices(
        torch.as_tensor(f), torch.ones(f.shape, dtype=torch.bool),
        ce._f32(spec.log_lo), ce._f32(1.0 / spec.width), spec.n_bins + 2)
    np.testing.assert_array_equal(
        got.histogram_counts, np.bincount(bins.numpy(),
                                          minlength=spec.n_bins + 2))


@pytest.mark.parametrize("hb,binned", [(4096, True), (4000, False),
                                       (4160, False), (20002, False),
                                       (64, True)])
def test_in_kernel_hist_follows_the_jax_rule(hb, binned):
    assert ce.in_kernel_hist(hb, True) is binned
    assert not ce.in_kernel_hist(hb, False)


def test_launch_geometry_takes_20000_cells():
    """The grid no longer depends on the histogram: a chunk of 20000 cells
    plans its launch (the card used to refuse past 12288 cells); the
    kernel then writes finals and the histogram kernel counts them."""
    assert ce._launch_geometry(132, 1 << 24, 256, 8) == 132 * 8
    assert ce._launch_geometry(132, 8192 + 777, 256, 8) == 36
    assert not ce.in_kernel_hist(20002, True)
    assert not hasattr(ce, "MAX_HIST_CELLS")


# ---------------------------------------------------------------------------
# ROADMAP queue 3, F5: the plain bin's log on the CPU does not depend on the
# thread count or the slicing.
# ---------------------------------------------------------------------------

F5_SIZES = (1, 15, 32767, 32768, 32769, 49152, 1 << 20)
F5_SLICE = 1001
F5_HB = 4096


def _f5_inputs(n):
    """Lognormal finals around 1000 with the edge cases up front: zero,
    below the 1e-37 floor, +inf, the float32 top, exactly 1."""
    rng = np.random.default_rng(n)
    vals = np.exp(rng.normal(np.log(1000.0), 1.5, n)).astype(np.float32)
    head = np.float32([0.0, 1e-38, np.inf, 3e38, 1.0])[:n]
    vals[:head.size] = head
    return torch.from_numpy(vals), torch.from_numpy(np.arange(n) % 17 != 9)


def _f5_bins(vals, mask):
    return ce._kernel_bin_indices(vals, mask, ce._f32(np.log(50.0)),
                                  ce._f32(410.3), F5_HB)


@pytest.mark.parametrize("n", F5_SIZES)
def test_plain_bins_ignore_threads_and_slicing(n):
    vals, mask = _f5_inputs(n)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = _f5_bins(vals, mask)
        torch.set_num_threads(6)
        six = _f5_bins(vals, mask)
        sliced = torch.cat([_f5_bins(vals[i:i + F5_SLICE],
                                     mask[i:i + F5_SLICE])
                            for i in range(0, n, F5_SLICE)])
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(one, six)
    assert torch.equal(one, sliced)


def test_cpu_log_is_the_rounded_float64_log():
    """``log_f32`` on the CPU is float64's log rounded to float32 (numpy's
    as the reference), +inf at +inf."""
    vals, _ = _f5_inputs(1 << 20)
    vals = torch.clamp_min(vals, 1e-37)
    want = np.log(vals.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(ce.log_f32(vals).numpy(), want)


@pytest.mark.parametrize("x", [0.0, -0.0, -1.0, 1.0, float("inf"),
                               float("-inf"), float("nan")])
def test_cpu_log_outside_the_series(x):
    """Where the series does not apply (0, below 0, the infinities, NaN)
    and at 1, ``log_f32`` gives ``torch.log``'s value."""
    t = torch.tensor([x], dtype=torch.float32)
    np.testing.assert_array_equal(ce.log_f32(t).numpy(), torch.log(t).numpy())
