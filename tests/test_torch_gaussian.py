"""The port's Gaussian month loop and CLT sampler against the JAX package,
on the CPU, and the sampler routing.

The JAX side runs as tests/test_torch_engine.py runs it: the arithmetic
counter stream (SMMC_PRNG_IMPL=arith) and the Pallas kernels in interpret
mode with 8192-path chunks. The port runs the plain PyTorch versions of its
kernels (device="cpu"). Both get the same inputs.

Neither sampler is bit-exact against XLA on the CPU, so both are held to
relative bars, as the terminal law is:

- ICDF: XLA contracts a + b*z and the erfinv polynomial steps into fmas,
  and its log1p differs from torch's by an ulp; the port rounds each step
  (as its CUDA build, -fmad=false, does). A month's growth then differs by
  an ulp now and then, and the differences compound over the horizon.
- CLT: the bf16 x bf16 product accumulates in float32 in another order,
  the row sums and the prefix run in another order, and log/exp differ by
  an ulp.

A count below the target may differ only for a final within the bar of
the target (``_assert_counts_close``).
"""

import hashlib

import numpy as np
import pytest

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_torch.ops import clt as port_clt
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions
from stock_market_monte_carlo_tpu.engine import engine as jax_engine
from stock_market_monte_carlo_tpu.ops import pallas_engine as pe
from test_arith_golden import GOLDEN, N as GOLDEN_N
from test_torch_engine import CPU, STRATEGY_NAMES, _assert_hist_close
from test_torch_engine import _strategy

# Finals bars, measured against these bars: ICDF at T=12 3.6e-7, at
# T=360 2.3e-6 (fixed percent); CLT at 2*8192+5 x 360 1.7e-6.
ICDF_REL = {12: 1e-6, 360: 5e-6}
CLT_REL = 5e-6
# moments are sums over many finals whose errors do not line up
MOMENTS_REL = 1e-6


def _run_both(monkeypatch, model, n, t, *, sampler="icdf", strategy=None,
              track_withdrawn=True, target=None, seed=3):
    """(port, jax) SimulationResults with finals, same inputs."""
    strategy = strategy or smmc.NoWithdrawal()
    monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
    want = smmc.simulate_stats(
        model, n, t, seed=seed, strategy=strategy, target_amount=target,
        keep_final_values=True, options=JaxOptions(
            backend="pallas", chunk_paths=8192, gaussian_sampler=sampler,
            track_withdrawn=track_withdrawn))
    got = smt.simulate_stats(
        from_reference(model), n, t, seed=seed,
        strategy=from_reference(strategy), target_amount=target,
        keep_final_values=True, options=smt.EngineOptions(
            gaussian_sampler=sampler, track_withdrawn=track_withdrawn,
            **CPU))
    return got, want


def _assert_counts_close(got, want, target, rel):
    """Counts below the target agree, except for finals that lie within
    ``rel`` of the target (either side may put them below it)."""
    near = int(np.sum(np.abs(want.final_values / target - 1.0) <= rel))
    assert abs(got.moments.count_below - want.moments.count_below) <= near


def _assert_close(got, want, *, finals_rel, target=None):
    np.testing.assert_allclose(got.final_values, want.final_values,
                               rtol=finals_rel, atol=0)
    gm, wm = got.moments, want.moments
    assert gm.n == wm.n
    assert gm.min == pytest.approx(wm.min, rel=finals_rel, abs=0)
    assert gm.max == pytest.approx(wm.max, rel=finals_rel, abs=0)
    assert gm.mean == pytest.approx(wm.mean, rel=MOMENTS_REL)
    assert gm.std == pytest.approx(wm.std, rel=10 * MOMENTS_REL)
    assert gm.total_withdrawn == pytest.approx(wm.total_withdrawn,
                                               rel=MOMENTS_REL)
    if target is not None:
        _assert_counts_close(got, want, target, finals_rel)
    _assert_hist_close(got.histogram_counts, want.histogram_counts)


# ---------------------------------------------------------------------------
# Gaussian month loop (exact ICDF)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,t", [(s, 12) for s in STRATEGY_NAMES]
                         + [("none", 360)])
def test_gaussian_month_loop_matches_jax(name, t, monkeypatch):
    got, want = _run_both(monkeypatch, smmc.GaussianReturns(),
                          2 * 8192 + 5, t, strategy=_strategy(name),
                          target=1000.0)
    _assert_close(got, want, finals_rel=ICDF_REL[t], target=1000.0)
    # the same finals through the port's simulate_final_values
    f = smt.simulate_final_values(
        smt.GaussianReturns(), 2 * 8192 + 5, t, seed=3,
        strategy=from_reference(_strategy(name)),
        options=smt.EngineOptions(**CPU))
    np.testing.assert_array_equal(f, got.final_values)


# ---------------------------------------------------------------------------
# CLT sampler
# ---------------------------------------------------------------------------


def test_clt_golden_within_bars():
    """GOLDEN["clt"] pins the JAX CPU values; the port meets them within
    the CLT bar (measured 1.2e-7 on the head, probes exact)."""
    g = GOLDEN["clt"]
    f = smt.simulate_final_values(
        smt.GaussianReturns(), GOLDEN_N, g["t"], seed=12,
        options=smt.EngineOptions(gaussian_sampler="clt", **CPU))
    assert f.shape == (GOLDEN_N,)
    np.testing.assert_allclose(f[:4], np.float32(g["head"]), rtol=CLT_REL)
    for idx, val in g["probes"].items():
        assert f[idx] == pytest.approx(val, rel=CLT_REL)
    assert float(np.sum(f, dtype=np.float64)) == pytest.approx(
        g["total"], rel=MOMENTS_REL)


# variant: (strategy, gaussian_sampler, track_withdrawn). The prefix
# variant's schedule keeps the months whose keep factor XLA's jit rounds as
# the port's host array does (test_torch_engine._schedule).
_CLT_CASES = {
    "plain": ("none", "clt", True),
    "keep_fold": ("fixed_percent", "clt", False),
    "prefix": ("variable_percent", "clt-prefix", True),
}


@pytest.mark.parametrize("variant", sorted(_CLT_CASES))
def test_clt_matches_jax(variant, monkeypatch):
    name, sampler, track = _CLT_CASES[variant]
    strategy = _strategy(name)
    model = smmc.GaussianReturns()
    assert port_engine._effective_sampler(
        from_reference(model), from_reference(strategy),
        smt.EngineOptions(gaussian_sampler=sampler, track_withdrawn=track,
                          **CPU)) == {"plain": "clt", "keep_fold": "clt-nw",
                                      "prefix": "clt-prefix"}[variant]
    got, want = _run_both(monkeypatch, model, 2 * 8192 + 5, 360,
                          sampler=sampler, strategy=strategy,
                          track_withdrawn=track, target=5000.0)
    _assert_close(got, want, finals_rel=CLT_REL, target=5000.0)
    if variant == "prefix":
        assert got.moments.total_withdrawn > 0.0
    want_f = smmc.simulate_final_values(
        model, 2 * 8192 + 5, 360, seed=3, strategy=strategy,
        options=JaxOptions(backend="pallas", chunk_paths=8192,
                           gaussian_sampler=sampler, track_withdrawn=track))
    got_f = smt.simulate_final_values(
        from_reference(model), 2 * 8192 + 5, 360, seed=3,
        strategy=from_reference(strategy),
        options=smt.EngineOptions(gaussian_sampler=sampler,
                                  track_withdrawn=track, **CPU))
    np.testing.assert_allclose(got_f, want_f, rtol=CLT_REL, atol=0)


@pytest.mark.parametrize("variant", ["plain", "prefix"])
def test_clt_ragged_last_tile_matches_jax(variant, monkeypatch):
    """The last chunk's valid paths end inside a CLT tile (4096 paths, or
    2048 for the prefix variant): the mask cuts inside that tile."""
    name, sampler, track = _CLT_CASES[variant]
    strategy = _strategy(name)
    p_tile = port_clt.tile_paths(variant)
    n = 8192 + p_tile + 100
    got, want = _run_both(monkeypatch, smmc.GaussianReturns(0.7, 4.1), n,
                          7, sampler=sampler, strategy=strategy,
                          track_withdrawn=track, target=1000.0, seed=21)
    assert got.final_values.shape == (n,)
    _assert_close(got, want, finals_rel=CLT_REL, target=1000.0)


def test_clt_constants_match_jax():
    """Q and its column constants: bit for bit, and the port's copy of
    the matrix file byte for byte."""
    q, colscale, colshift = port_clt.clt_qmatrix()
    want_q, want_scale, want_shift = pe._clt_qmatrix(128)
    np.testing.assert_array_equal(q, np.asarray(want_q).view(np.uint16))
    np.testing.assert_array_equal(colscale, want_scale[0])
    np.testing.assert_array_equal(colshift, want_shift[0])
    assert colscale.dtype == colshift.dtype == np.float32
    jax_bytes = (pe.__file__.rsplit("/", 1)[0] + "/_clt_q128.npy")
    with open(jax_bytes, "rb") as f:
        assert port_clt._Q_PATH.read_bytes() == f.read()
    assert hashlib.sha256(port_clt._Q_PATH.read_bytes()).hexdigest() == \
        pe._CLT_Q128_SHA256 == port_clt._CLT_Q128_SHA256


def test_clt_tiles_match_jax():
    assert (port_clt.CLT_P, port_clt.CLT_P_STRATEGY, port_clt.CLT_K) == \
        (pe.CLT_P, pe.CLT_P_STRATEGY, pe.CLT_K)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

_ROUTING_MODELS = {
    "historical": smmc.HistoricalBootstrap.from_csv(),
    "gaussian": smmc.GaussianReturns(),
    # 1 + mean/100 <= 16 std/100: the extreme-volatility guard
    "gaussian_extreme": smmc.GaussianReturns(0.5, 7.0),
    "gaussian_edge": smmc.GaussianReturns(0.0, 6.25),
}


@pytest.mark.parametrize("model_name", sorted(_ROUTING_MODELS))
def test_effective_sampler_matches_jax(model_name):
    model = _ROUTING_MODELS[model_name]
    labels = set()
    for name in STRATEGY_NAMES:
        strategy = _strategy(name)
        for sampler in ("icdf", "clt", "clt-prefix"):
            for track in (True, False):
                for law in (False, True):
                    want = jax_engine._effective_sampler(
                        model, strategy, "pallas", JaxOptions(
                            gaussian_sampler=sampler, track_withdrawn=track,
                            terminal_law=law))
                    got = port_engine._effective_sampler(
                        from_reference(model), from_reference(strategy),
                        smt.EngineOptions(gaussian_sampler=sampler,
                                          track_withdrawn=track,
                                          terminal_law=law, device="cpu"))
                    assert got == want, (name, sampler, track, law)
                    labels.add(got)
    want_labels = {"historical": {"icdf", "law"},
                   "gaussian": {"icdf", "law", "clt", "clt-nw",
                                "clt-prefix"},
                   "gaussian_extreme": {"icdf", "law"},
                   "gaussian_edge": {"icdf", "law"}}[model_name]
    assert labels == want_labels
