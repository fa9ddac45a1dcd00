"""The port's engine against the JAX package, on the CPU.

The JAX side runs as tests/test_arith_golden.py runs it: the arithmetic
counter stream (SMMC_PRNG_IMPL=arith) and the Pallas kernels in interpret
mode with 8192-path chunks. The port runs the plain PyTorch versions of its
kernels (device="cpu"). Both get the same inputs, made with numpy.
"""

import functools
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_torch.ops import terminal_law as port_law
from stock_market_monte_carlo_torch.ops.reductions import zero_packed_stats
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions
from stock_market_monte_carlo_tpu.engine import engine as jax_engine
from stock_market_monte_carlo_tpu.ops import terminal_law as jax_law
from test_arith_golden import GOLDEN, N as GOLDEN_N

CPU = dict(device="cpu", chunk_paths=8192)
STRATEGY_NAMES = ("fixed_amount", "fixed_percent", "none",
                  "variable_percent")
# XLA's CPU backend contracts total * g - amount into one fma (jax.jit of
# a * b - c on the CPU equals an fma for every sample tried); the port
# rounds the product first, as its CUDA build (-fmad=false) does.
# Measured at T=12: 1976 of 24699 finals differ, by at most 4.2e-7
# relative. Every other month-loop strategy is bit-exact.
FINALS_REL = {"fixed_amount": 1e-6}


@functools.lru_cache(maxsize=1)
def _schedule():
    """A withdrawal schedule from a seeded draw, keeping the months whose
    keep factor the JAX kernel (jitted ``_keep_factors``) and the port's
    host ``_keep_factors_np`` round alike: under jit XLA rounds 1 - p/100
    one ulp away for some p (for 1 of 12 draws here), and the port takes
    the host array as the single source of truth."""
    import jax

    draw = smmc.VariablePercentWithdrawal(
        np.random.default_rng(7).uniform(0.0, 1.0, 2048).astype(np.float32))
    jit_keep = np.asarray(jax.jit(
        lambda st: jax_engine._keep_factors(st, 2048))(draw))
    same = jit_keep == jax_engine._keep_factors_np(draw, 2048)
    return np.asarray(draw.percent_schedule)[same][:360]


def _strategy(name):
    return {
        "none": smmc.NoWithdrawal,
        "fixed_percent": lambda: smmc.FixedPercentWithdrawal(0.4),
        "variable_percent": lambda: smmc.VariablePercentWithdrawal(
            _schedule()),
        "fixed_amount": lambda: smmc.FixedAmountWithdrawal(6.0),
    }[name]()


def _jax_stats(monkeypatch, model, n, t, **kw):
    monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
    opts = JaxOptions(backend="pallas", chunk_paths=8192,
                      terminal_law=kw.pop("terminal_law", False),
                      track_withdrawn=kw.pop("track_withdrawn", True))
    return smmc.simulate_stats(model, n, t, options=opts, **kw)


def _assert_hist_close(got, want):
    """Histogram: equal totals; cells equal except a value within an ulp
    of a bin edge moving to the neighbouring cell (log differs by an ulp
    between XLA's and torch's CPU log)."""
    assert got.sum() == want.sum()
    assert np.abs(got - want).max() <= 2


def _assert_same_stats(got, want, *, moments_rel, std_rel, finals_rel=0.0):
    """min and max are finals, held to the finals' bar (0: exact)."""
    gm, wm = got.moments, want.moments
    assert gm.n == wm.n
    assert gm.count_below == wm.count_below
    assert gm.min == pytest.approx(wm.min, rel=finals_rel, abs=0)
    assert gm.max == pytest.approx(wm.max, rel=finals_rel, abs=0)
    assert gm.mean == pytest.approx(wm.mean, rel=moments_rel)
    assert gm.std == pytest.approx(wm.std, rel=std_rel)
    _assert_hist_close(got.histogram_counts, want.histogram_counts)


# ---------------------------------------------------------------------------
# Goldens of the arithmetic stream
# ---------------------------------------------------------------------------


def test_historical_golden_bit_exact():
    g = GOLDEN["historical"]
    f = smt.simulate_final_values(smt.HistoricalBootstrap.from_csv(),
                                  GOLDEN_N, g["t"], seed=12,
                                  options=smt.EngineOptions(**CPU))
    assert f.shape == (GOLDEN_N,)
    np.testing.assert_array_equal(f[:4], np.float32(g["head"]))
    for idx, val in g["probes"].items():
        assert f[idx] == np.float32(val), (idx, f[idx])
    assert float(np.sum(f, dtype=np.float64)) == pytest.approx(
        g["total"], rel=1e-12)


def test_law_golden_within_bars():
    """The law goes through log1p and exp, which differ by an ulp between
    XLA and torch: relative bars."""
    g = GOLDEN["law"]
    f = smt.simulate_final_values(
        smt.GaussianReturns(), GOLDEN_N, g["t"], seed=12,
        options=smt.EngineOptions(terminal_law=True, **CPU))
    np.testing.assert_allclose(f[:4], np.float32(g["head"]), rtol=2e-6)
    for idx, val in g["probes"].items():
        assert f[idx] == pytest.approx(val, rel=2e-6)
    assert float(np.sum(f, dtype=np.float64)) == pytest.approx(
        g["total"], rel=1e-6)


# ---------------------------------------------------------------------------
# Slice parity against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_month_loop_matches_jax(name, monkeypatch):
    n, t, target = 3 * 8192 + 123, 12, 1000.0
    model = smmc.HistoricalBootstrap.from_csv()
    strategy = _strategy(name)
    finals_rel = FINALS_REL.get(name, 0.0)
    want = _jax_stats(monkeypatch, model, n, t, seed=5, strategy=strategy,
                      target_amount=target, keep_final_values=True)
    port_args = (from_reference(model), n, t)
    port_kw = dict(seed=5, strategy=from_reference(strategy),
                   target_amount=target)
    got = smt.simulate_stats(*port_args, keep_final_values=True,
                             options=smt.EngineOptions(**CPU), **port_kw)
    np.testing.assert_allclose(got.final_values, want.final_values,
                               rtol=finals_rel, atol=0)
    _assert_same_stats(got, want, moments_rel=1e-6, std_rel=1e-5,
                       finals_rel=finals_rel)
    assert got.moments.total_withdrawn == pytest.approx(
        want.moments.total_withdrawn, rel=1e-6)
    # the deferred-absorb path (nothing consumes per-chunk results) gives
    # the same merge as the per-chunk path
    deferred = smt.simulate_stats(*port_args,
                                  options=smt.EngineOptions(**CPU),
                                  **port_kw)
    assert deferred.moments == got.moments
    np.testing.assert_array_equal(deferred.histogram_counts,
                                  got.histogram_counts)


@pytest.mark.parametrize("sampler", ["clt", "clt-prefix"])
def test_historical_ignores_clt_sampler_as_jax_does(sampler, monkeypatch):
    """A CLT ``gaussian_sampler`` on a historical model runs the
    historical month loop, in the JAX package and in the port."""
    n, t = 8192 + 321, 12
    model = smmc.HistoricalBootstrap.from_csv()
    strategy = _strategy("fixed_percent")
    monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
    want = smmc.simulate_final_values(
        model, n, t, seed=8, strategy=strategy, options=JaxOptions(
            backend="pallas", chunk_paths=8192, gaussian_sampler=sampler))
    got = smt.simulate_final_values(
        from_reference(model), n, t, seed=8,
        strategy=from_reference(strategy),
        options=smt.EngineOptions(gaussian_sampler=sampler, **CPU))
    np.testing.assert_array_equal(got, want)
    icdf = smt.simulate_final_values(
        from_reference(model), n, t, seed=8,
        strategy=from_reference(strategy), options=smt.EngineOptions(**CPU))
    np.testing.assert_array_equal(got, icdf)


@pytest.mark.parametrize("kind", ["historical", "gaussian"])
def test_terminal_law_matches_jax(kind, monkeypatch):
    n, t, target = 2 * 8192 + 5, 360, 5000.0
    model = (smmc.HistoricalBootstrap.from_csv() if kind == "historical"
             else smmc.GaussianReturns())
    strategy = smmc.FixedPercentWithdrawal(0.1)
    port_model, port_strategy = from_reference(model), from_reference(
        strategy)

    want_op = jax_law.fit_terminal_law(model, strategy, t, 1000.0).operand()
    got_op = port_law.fit_terminal_law(port_model, port_strategy, t,
                                       1000.0).operand()
    np.testing.assert_array_equal(got_op, want_op)

    want = _jax_stats(monkeypatch, model, n, t, seed=3, strategy=strategy,
                      target_amount=target, terminal_law=True,
                      track_withdrawn=False)
    got = smt.simulate_stats(
        port_model, n, t, seed=3, strategy=port_strategy,
        target_amount=target, options=smt.EngineOptions(
            terminal_law=True, track_withdrawn=False, **CPU))
    # the law's finals go through log1p and exp (an ulp apart between
    # XLA's and torch's CPU versions) and XLA contracts the Clenshaw step
    # into fmas: its finals, and so min and max, meet a relative bar
    _assert_same_stats(got, want, moments_rel=1e-5, std_rel=1e-5,
                       finals_rel=2e-6)

    want_f = smmc.simulate_final_values(
        model, n, t, seed=3, strategy=strategy, options=JaxOptions(
            backend="pallas", chunk_paths=8192, terminal_law=True,
            track_withdrawn=False))
    got_f = smt.simulate_final_values(
        port_model, n, t, seed=3, strategy=port_strategy,
        options=smt.EngineOptions(terminal_law=True, track_withdrawn=False,
                                  **CPU))
    assert np.max(np.abs(got_f / want_f - 1.0)) <= 2e-6


# ---------------------------------------------------------------------------
# Host analytics
# ---------------------------------------------------------------------------

_MODELS = {
    "historical": smmc.HistoricalBootstrap.from_csv(),
    "gaussian": smmc.GaussianReturns(0.7, 4.1),
}


@pytest.mark.parametrize("model_name", sorted(_MODELS))
@pytest.mark.parametrize("strategy_name", STRATEGY_NAMES)
def test_host_analytics_match_jax(model_name, strategy_name):
    model, strategy = _MODELS[model_name], _strategy(strategy_name)
    pm, ps = from_reference(model), from_reference(strategy)
    for t in (1, 12, 360):
        want = jax_engine.make_histogram_spec(model, strategy, t, 1000.0,
                                              4094)
        got = port_engine.make_histogram_spec(pm, ps, t, 1000.0, 4094)
        assert (got.lo, got.hi, got.n_bins) == (want.lo, want.hi,
                                                want.n_bins)
        assert port_engine.analytic_moment_shift(pm, ps, t) == \
            jax_engine.analytic_moment_shift(model, strategy, t)
    assert port_engine.log_growth_moments(pm) == \
        jax_engine.log_growth_moments(model)


def test_absorb_matches_jax():
    rng = np.random.default_rng(11)
    v0 = 1250.0
    scale = np.array([1.0, v0, v0**2, v0**3, v0**4, v0, v0, 1.0, v0])
    rows = rng.normal(size=(5, 9)).astype(np.float32)
    rows[:, 0] = [8192, 8192, 8192, 8192, 77]
    hists = rng.integers(0, 100, size=(5, 4096)).astype(np.float32)
    finals = rng.uniform(500, 2000, size=(5, 8192)).astype(np.float32)
    totals = []
    for absorb in (jax_engine._absorb, port_engine._absorb):
        stats = zero_packed_stats()
        hist = np.zeros(4096)
        parts = []
        for i in range(5):
            valid = int(rows[i, 0])
            stats, hist, _ = absorb(
                ((rows[i], hists[i], finals[i]), 0, valid), stats, hist,
                parts, True, scale, 1.0625)
        totals.append((stats, hist, np.concatenate(parts)))
    for a, b in zip(*totals):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Contracts
# ---------------------------------------------------------------------------


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-GPU contract does "
                    "not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smt.simulate_stats(smt.HistoricalBootstrap.from_csv(), 8192, 12)


def _out_of_slice_calls():
    hist = smt.HistoricalBootstrap.from_csv()
    cpu = smt.EngineOptions(device="cpu")
    return {
        "checkpoint": lambda: smt.simulate_stats(
            hist, 8192, 12, options=cpu, checkpoint_path="x.npz",
            mesh=object()),
        "mesh": lambda: smt.simulate_stats(hist, 8192, 12, options=cpu,
                                           mesh=object()),
        "bands_mesh": lambda: smt.simulate_bands(hist, 8192, 12, options=cpu,
                                                 mesh=object()),
    }


@pytest.mark.parametrize("case", sorted(_out_of_slice_calls()))
def test_out_of_slice_raises_with_roadmap_item(case):
    """Meshes are ported (ROADMAP queue 1 item 13, tests/
    test_torch_mesh.py): a mesh that is no ``PathsMesh`` now raises, before
    any work, naming the helper that makes one."""
    with pytest.raises(TypeError, match="parallel.paths_mesh"):
        _out_of_slice_calls()[case]()


def _jax_key(seed):
    import jax

    return jax.random.key(seed), jax.random.fold_in(jax.random.key(seed),
                                                    0x50B0)


def _port_key(seed):
    from stock_market_monte_carlo_torch.ops import threefry

    return threefry.key(seed), threefry.fold_in(threefry.key(seed), 0x50B0)


def _growth_pair(model):
    """sample_growth of paths [8192, 3*8192) in both packages."""
    import jax.numpy as jnp

    want = jax_engine.sample_growth(model, *_jax_key(4), jnp.uint32(8192),
                                    (2 * 8192, 12))
    got = port_engine.sample_growth(from_reference(model), *_port_key(4),
                                    8192, (2 * 8192, 12))
    return got.numpy(), np.asarray(want)


def _formerly_out_of_slice():
    """Calls the port refused before it ran the Sobol models, the
    reference-parity stream and RQMC: each now runs and returns what the
    JAX package returns, as (got, want) arrays."""
    hist = smmc.HistoricalBootstrap.from_csv()

    def reference_rng():
        ref = smmc.HistoricalBootstrap(hist.returns_pct, rng="reference")
        got = from_reference(ref)
        assert got.rng == "reference"
        return (np.asarray(got.sample_returns_pct_reference(8190, (6, 12))),
                np.asarray(ref.sample_returns_pct_reference(8190, (6, 12))))

    def sobol():
        ref = smmc.SobolGaussianReturns.create(12, index_offset=5)
        got = from_reference(ref)
        assert got.index_offset == 5 and got.kind == "sobol_gaussian"
        return got.direction, np.asarray(ref.direction)

    def rqmc(monkeypatch):
        monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
        want = smmc.rqmc_estimate(hist, 8192, 12, replicates=2,
                                  options=JaxOptions(backend="pallas",
                                                     chunk_paths=8192))
        got = smt.rqmc_estimate(from_reference(hist), 8192, 12, replicates=2,
                                options=smt.EngineOptions(**CPU))
        return got.replicate_means, want.replicate_means

    return {
        "reference_rng": reference_rng,
        "sobol": sobol,
        "quasi_growth": lambda: _growth_pair(
            smmc.SobolHistoricalBootstrap.create(hist.returns_pct, 12)),
        "reference_growth": lambda: _growth_pair(
            smmc.HistoricalBootstrap(hist.returns_pct, rng="reference")),
        "rqmc": rqmc,
    }


@pytest.mark.parametrize("case", sorted(_formerly_out_of_slice()))
def test_formerly_out_of_slice_calls_match_jax(case, monkeypatch):
    call = _formerly_out_of_slice()[case]
    got, want = call(monkeypatch) if case == "rqmc" else call()
    if case == "rqmc":
        # float64 merges of float32 power sums, summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_unknown_model_rejected():
    with pytest.raises(TypeError, match="not a market model"):
        smt.simulate_stats(types.SimpleNamespace(kind="other"), 8192, 12,
                           options=smt.EngineOptions(device="cpu"))


def test_xla_backend_rejected():
    with pytest.raises(ValueError, match="no XLA backend"):
        smt.EngineOptions(backend="xla", device="cpu")
    assert smt.EngineOptions(backend="pallas").backend == "pallas"


def test_port_import_leaves_jax_out():
    code = ("import sys, stock_market_monte_carlo_torch; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith("
            "'stock_market_monte_carlo_tpu')))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=repo)
    assert out.stdout.strip() == "[]"
