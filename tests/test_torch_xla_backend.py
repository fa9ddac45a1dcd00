"""The port's XLA backend (``EngineOptions(backend="xla")``) against the
JAX package's XLA backend, on the CPU.

The JAX side runs ``backend="xla"`` as it runs off a TPU: the threefry
stream (``jax.random``), ``engine.chunk_stats`` over a materialised (B, T)
growth buffer, plain XLA on the CPU. The port runs ``device="cpu"``: its
``chunk_stats`` (the same structure in plain PyTorch) and the terminal
law's threefry draw; the kernels' plain versions (``cuda_engine.
threefry_loop_chunk_plain``, ``law_chunk_plain(draw="threefry")``), which
the card holds its kernels to, are held here to JAX's ``chunk_stats`` and
``_law_finals_xla``. The Sobol historical model and the reference stream
draw the same points on both JAX backends, so the port keeps their
month-loop kernels; the Sobol Gaussian model does not, so the port runs
its XLA draw.

The draws agree with JAX's bit for bit (tests/test_torch_threefry.py);
what differs is float rounding, each bar below measured on these inputs
(8192 + 777 paths, seed 5):

- XLA multiplies the months of ``jnp.prod`` and ``jnp.cumprod`` in its own
  order and contracts some steps into fmas on the CPU (the erfinv steps,
  ``total * g - amount``); the port multiplies month by month. Finals
  agree within 1.2e-6 relative at 12 months and 4.9e-6 at 360 (none and
  variable percent), only 3-7 % of them bit for bit at 360.
- Under a fixed percent XLA folds the growth's 0.01 and the constant keep
  factor into one float32 constant (measured: JAX's finals sit 7.9e-6
  below the float64 product of its own draws at 360 months, 1.1e-8 from
  the product with the folded constant; the port's 1.2e-8 from the
  unfolded one). The bar at 360 months is 2e-5 (measured 1.3e-5).
- Under a fixed amount a path near depletion loses its digits to the
  subtraction: its error is relative to the initial capital (measured
  below 5e-7 of it at 12 months and 9.9e-6 at 360).
- JAX sums its float32 stats row in float32, the port in float64, so the
  moments are held to the float64 moments of JAX's finals.
- The Sobol Gaussian draw's plain version at 360 months (one ragged chunk
  at tile 3) sits within 3.2e-6 of JAX's finals under the fixed percent
  and 5.0e-6 of the capital under the fixed amount: inside the bars
  above.

Counts and histogram cells are exact but for finals within the bar of the
target or of a cell edge: the difference is bounded by those finals.
"""

import functools

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import checkpoint as ckpt
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_torch.ops import sobol as port_sobol
from stock_market_monte_carlo_torch.parallel._ranks import run_ranks
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions
from stock_market_monte_carlo_tpu.engine import engine as jax_engine
from stock_market_monte_carlo_tpu.ops import reductions as jax_red
from test_torch_engine import STRATEGY_NAMES, _strategy

N = 8192 + 777            # two tiles, the second ragged
SEED = 5
TARGET = 1000.0
V0 = 1000.0
XLA = dict(backend="xla", device="cpu")
HIST = smmc.HistoricalBootstrap.from_csv()
# (months, strategy) -> the finals' bar (relative; under a fixed amount
# relative to the larger of the final and the initial capital)
FINALS_REL = {
    (12, "none"): 2e-6, (12, "fixed_percent"): 2e-6,
    (12, "variable_percent"): 2e-6, (12, "fixed_amount"): 1e-6,
    (360, "none"): 6e-6, (360, "fixed_percent"): 2e-5,
    (360, "variable_percent"): 6e-6, (360, "fixed_amount"): 2e-5,
}
# the terminal law: one threefry normal a path, whose erfinv XLA
# contracts into fmas, through 47 Clenshaw steps and exp (measured 2.3e-7)
LAW_REL = 1e-6
# the law's months: its fit (an FFT oracle over the horizon) in both
# packages is the test's cost
LAW_T = 60
# chunk sums of a run at another chunk size (float32 rows)
SUM_REL = 1e-6
# Under the fixed amount the moments are not centred (no analytic mean),
# so the variance cancels mean^2/var ~ 1150 times the float32 rounding of
# the per-path terms: the std sits up to 5e-5 from the float64 std of the
# same finals (measured here; tests/test_torch_quasi.py measured 2-4e-5)
STD_REL = {"fixed_amount": 1e-4}


def _model(kind, t):
    if kind == "historical":
        return HIST
    if kind == "gaussian":
        return smmc.GaussianReturns()
    if kind == "sobol_gaussian":
        return smmc.SobolGaussianReturns.create(t)
    if kind == "sobol_historical":
        return smmc.SobolHistoricalBootstrap.create(HIST.returns_pct, t)
    return smmc.HistoricalBootstrap(returns_pct=HIST.returns_pct,
                                    rng="reference")


@functools.lru_cache(maxsize=None)
def _jax_run(kind, name, t, **opts):
    return smmc.simulate_stats(
        _model(kind, t), N, t, seed=SEED, strategy=_strategy(name),
        target_amount=TARGET, keep_final_values=True,
        options=JaxOptions(backend="xla", **opts))


def _port_run(kind, name, t, n=N, **opts):
    return smt.simulate_stats(
        from_reference(_model(kind, t)), n, t, seed=SEED,
        strategy=from_reference(_strategy(name)), target_amount=TARGET,
        keep_final_values=True,
        options=smt.EngineOptions(**dict(XLA, **opts)))


def _tol(finals, rel, name):
    """Each final's bar in value: relative, under a fixed amount relative
    to the larger of the final and the initial capital."""
    mag = np.abs(finals.astype(np.float64))
    return rel * (np.maximum(mag, V0) if name == "fixed_amount" else mag)


def _near_edges(finals, tol, spec):
    """Finals within ``tol`` of an edge of the histogram's cells (the log
    grid's edges and its lower end)."""
    f = finals.astype(np.float64)
    edges = np.exp(spec.log_lo + spec.width * np.arange(spec.n_bins + 1))
    i = np.clip(np.searchsorted(edges, f), 1, edges.size - 1)
    gap = np.minimum(np.abs(f - edges[i - 1]), np.abs(f - edges[i]))
    return int(np.sum(gap <= tol))


def assert_matches(got, want, name, rel):
    """The port's run against JAX's: finals within the bar, n exact, the
    count below the target and the cells within the finals near them,
    the moments within the bar of JAX's finals' float64 moments, the
    withdrawn total within the bar of JAX's."""
    w, g = want.final_values, got.final_values
    tol = _tol(w, rel, name)
    assert np.all(np.abs(g.astype(np.float64) - w) <= tol), np.max(
        np.abs(g.astype(np.float64) - w) / tol)
    assert got.moments.n == want.moments.n == N
    near_target = int(np.sum(np.abs(w - TARGET) <= tol))
    assert abs(got.moments.count_below - want.moments.count_below) \
        <= near_target
    assert got.histogram_counts.sum() == want.histogram_counts.sum() == N
    near = _near_edges(w, tol, want.histogram_spec)
    assert np.abs(got.histogram_counts - want.histogram_counts).sum() \
        <= 2 * near
    w64 = w.astype(np.float64)
    scale = V0 if name == "fixed_amount" else 0.0
    assert got.mean == pytest.approx(w64.mean(), rel=rel, abs=rel * scale)
    assert got.std == pytest.approx(w64.std(), rel=max(rel, STD_REL.get(
        name, 0.0)))
    assert got.moments.total_withdrawn == pytest.approx(
        want.moments.total_withdrawn, rel=rel)


@pytest.mark.parametrize("t", (12, 360))
@pytest.mark.parametrize("name", STRATEGY_NAMES)
@pytest.mark.parametrize("kind", ("historical", "gaussian"))
def test_counter_models_match_jax(kind, name, t):
    assert_matches(_port_run(kind, name, t), _jax_run(kind, name, t), name,
                   FINALS_REL[t, name])


@pytest.mark.parametrize("name", STRATEGY_NAMES)
@pytest.mark.parametrize("kind", ("sobol_gaussian", "sobol_historical",
                                  "reference"))
def test_sobol_and_reference_models_match_jax(kind, name):
    assert_matches(_port_run(kind, name, 12), _jax_run(kind, name, 12),
                   name, FINALS_REL[12, name])


@pytest.mark.parametrize("kind", ("historical", "gaussian"))
def test_terminal_law_matches_jax(kind):
    opts = dict(terminal_law=True, track_withdrawn=False)
    want = _jax_run(kind, "fixed_percent", LAW_T, **opts)
    got = _port_run(kind, "fixed_percent", LAW_T, **opts)
    assert_matches(got, want, "fixed_percent", LAW_REL)


def _kernel_growth(model, t, seed):
    """(8192, t) growth of the model's month-loop kernel draw (its plain
    version) for the first tile."""
    pm = from_reference(model)
    cpu = torch.device("cpu")
    table, draw = ce.draw_operands(pm, cpu, t, port_sobol.digital_shift(
        port_engine._scramble_key(seed, cpu), t) if pm.is_quasi else None)
    growth = ce.month_growth(
        cpu, table, draw=draw.pop("draw"), n_table=draw["n_table"],
        a=draw["a"], b=draw["b"], seed_base=0, tile0=0, n_paths=8192,
        direction=draw.get("direction"), shift=draw.get("sobol_shift"),
        index_offset=draw.get("index_offset", 0))
    return np.stack([growth(m).reshape(-1).numpy() for m in range(t)], 1)


@pytest.mark.parametrize("kind", ("sobol_gaussian", "sobol_historical",
                                  "reference"))
def test_kernel_points_against_jax_xla_draw(kind):
    """JAX's XLA ``sample_growth`` against the port's month-loop kernel
    draw: the same points for the Sobol historical model and the
    reference stream, which therefore keep their kernels under "xla"
    (and give the kernels' results bit for bit); other points for the
    Sobol Gaussian model (normal_icdf of the word's float, not the
    kernel's u23 normal), which runs its XLA draw."""
    import jax

    t = 12
    model = _model(kind, t)
    key = jax.random.key(SEED)
    want = np.asarray(jax_engine.sample_growth(
        model, key, jax.random.fold_in(key, 0x50B0), 0, (8192, t)))
    got = _kernel_growth(model, t, SEED)
    if kind == "sobol_gaussian":
        assert not np.array_equal(got, want)
        return
    np.testing.assert_array_equal(got, want)
    xla = _port_run(kind, "fixed_percent", t)
    kernels = _port_run(kind, "fixed_percent", t, backend="auto")
    np.testing.assert_array_equal(xla.final_values, kernels.final_values)
    assert xla.moments == kernels.moments


def _chunk_kw(model, strategy, t, valid, n_paths, tile0):
    spec = port_engine.make_histogram_spec(model, strategy, t, V0, 4094)
    return dict(valid=valid, n_paths=n_paths, v0=V0, target=TARGET,
                shift=port_engine.analytic_moment_shift(model, strategy, t),
                lo=spec.lo, log_lo=spec.log_lo, inv_w=1.0 / spec.width,
                hb=spec.n_bins + 2, with_hist=True, keep_finals=True,
                tile0=tile0)


# (draw, strategy, months): every draw and strategy at 12 months, every
# draw at 360 under the two withdrawals
PLAIN_CASES = [(kind, name, 12) for kind in ("historical", "gaussian",
                                             "sobol_gaussian")
               for name in ("none", "fixed_percent", "fixed_amount")] + [
    (kind, name, 360) for kind in ("historical", "gaussian",
                                   "sobol_gaussian")
    for name in ("fixed_percent", "fixed_amount")]


@pytest.mark.parametrize("kind,name,t", PLAIN_CASES)
def test_threefry_loop_plain_matches_jax_chunk_stats(kind, name, t):
    """The kernel's plain version on one ragged chunk at a tile offset
    against JAX's ``chunk_stats`` on the same keys: finals within the bar
    of the runs, cells within the finals near an edge."""
    import jax
    import jax.numpy as jnp

    tile0, valid = 3, 8192 + 501
    model, strategy = _model(kind, t), _strategy(name)
    pm, ps = from_reference(model), from_reference(strategy)
    kw = _chunk_kw(pm, ps, t, valid, 2 * 8192, tile0)
    spec = port_engine.make_histogram_spec(pm, ps, t, V0, 4094)
    root = jax.random.key(SEED)
    _, _, want = jax_engine.chunk_stats(
        model, strategy, root, jax.random.fold_in(root, 0x50B0),
        jnp.float32(V0), jnp.uint32(tile0 * 8192), jnp.int32(valid),
        jnp.float32(TARGET), n_periods=t, chunk_shape_b=2 * 8192,
        spec=jax_red.HistogramSpec(lo=spec.lo, hi=spec.hi,
                                   n_bins=spec.n_bins),
        keep_finals=True)
    want = np.asarray(want)[:valid]
    cpu = torch.device("cpu")
    table, draw = ce.threefry_operands(
        pm, cpu, t, port_sobol.digital_shift(
            port_engine._scramble_key(SEED, cpu), t) if pm.is_quasi else None)
    keep = torch.as_tensor(
        port_engine._keep_factors_np(ps, t) if name != "fixed_amount"
        else np.ones((t,), np.float32))
    stats, hist, finals = ce.threefry_loop_chunk(
        table, keep, strategy=ps.kind, amount=float(getattr(ps, "amount",
                                                            0.0)),
        n_periods=t, key=port_engine._segment_key(SEED, 0), **draw, **kw)
    finals = finals.numpy()
    tol = _tol(want, FINALS_REL[t, name], name)
    assert np.all(np.abs(finals.astype(np.float64) - want) <= tol)
    assert float(stats[0]) == valid and float(hist.sum()) == valid
    want_hist = np.bincount(ce._kernel_bin_indices(
        torch.tensor(want), torch.ones(valid, dtype=torch.bool),
        ce._f32(spec.log_lo), ce._f32(1.0 / spec.width),
        spec.n_bins + 2).numpy(), minlength=spec.n_bins + 3)[:-1]
    assert np.abs(hist.numpy() - want_hist).sum() <= 2 * _near_edges(
        want, tol, spec)


@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_compound_final_matches_jax(name):
    """``compound_final`` on the same seeded growth (a loss of up to 15 %
    a month, so the fixed amount depletes paths) against JAX's."""
    t = 60
    growth = np.random.default_rng(3).uniform(
        0.85, 1.2, (4096, t)).astype(np.float32)
    wf, ww = jax_engine.compound_final(growth, V0, _strategy(name))
    gf, gw = port_engine.compound_final(
        torch.as_tensor(growth), V0, from_reference(_strategy(name)))
    rel = FINALS_REL[12, name]
    wf, ww = np.asarray(wf, np.float64), np.asarray(ww, np.float64)
    assert np.all(np.abs(gf.numpy() - wf) <= _tol(wf, rel, name))
    assert np.all(np.abs(gw.numpy() - ww) <= _tol(ww, rel, name) + 1e-30)


def test_law_plain_matches_jax_law_finals():
    """The law kernel's plain threefry draw on one ragged chunk at a tile
    offset against JAX's ``_law_finals_xla`` on the same operand."""
    import jax

    from stock_market_monte_carlo_torch.ops import terminal_law as tlaw

    t, tile0, valid = LAW_T, 5, 8192 + 33
    pm = from_reference(HIST)
    op = tlaw.fit_terminal_law(pm, smt.NoWithdrawal(), t, V0).operand()
    root = jax.random.key(SEED)
    want = np.asarray(jax_engine._law_finals_xla(
        op, root, tile0 * 8192, 2 * 8192))[:valid]
    kw = _chunk_kw(pm, smt.NoWithdrawal(), t, valid, 2 * 8192, tile0)
    key = ce.law_key(port_engine._segment_key(SEED, 0))
    _, _, got = ce.law_chunk(torch.as_tensor(op), seed_base=0,
                             inv_zmax=1.0 / tlaw.LAW_ZMAX, draw="threefry",
                             key=key, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=LAW_REL, atol=0)


def test_chunk_size_invariance():
    """Finals, cells, n, min, max and the count below do not depend on
    the chunk size; the sums of float32 chunk rows agree within SUM_REL."""
    a = _port_run("historical", "fixed_percent", 12, n=3 * 8192 + 777,
                  chunk_paths=8192)
    b = _port_run("historical", "fixed_percent", 12, n=3 * 8192 + 777,
                  chunk_paths=2 * 8192)
    np.testing.assert_array_equal(a.final_values, b.final_values)
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)
    for f in ("n", "min", "max", "count_below"):
        assert getattr(a.moments, f) == getattr(b.moments, f)
    for f in ("mean", "std", "total_withdrawn"):
        assert getattr(a.moments, f) == pytest.approx(
            getattr(b.moments, f), rel=SUM_REL)


def test_xla_chunk_paths_as_jax():
    for t in (1, 12, 360, 3000):
        for chunk in (8192, 1 << 20, 1 << 24):
            assert port_engine._xla_chunk_paths(
                t, smt.EngineOptions(chunk_paths=chunk)) == \
                jax_engine._xla_chunk_paths(t, JaxOptions(chunk_paths=chunk))


def test_segmented_run_matches_jax():
    seg = 8192
    n = 3 * seg + 777
    want = smmc.simulate_stats(
        HIST, n, 12, seed=9, strategy=_strategy("fixed_percent"),
        target_amount=TARGET, keep_final_values=True,
        options=JaxOptions(backend="xla", chunk_paths=8192,
                           seed_segment_paths=seg))
    got = smt.simulate_stats(
        from_reference(HIST), n, 12, seed=9,
        strategy=from_reference(_strategy("fixed_percent")),
        target_amount=TARGET, keep_final_values=True,
        options=smt.EngineOptions(chunk_paths=8192, seed_segment_paths=seg,
                                  **XLA))
    np.testing.assert_allclose(got.final_values, want.final_values,
                               rtol=FINALS_REL[12, "fixed_percent"], atol=0)
    assert not np.array_equal(got.final_values[seg:2 * seg],
                              got.final_values[:seg])
    assert got.mean == pytest.approx(want.mean, rel=1e-6)


def xla_rank(mesh, n, t):
    """A rank's (or, with ``mesh=None``, the single process's) XLA-backend
    run on the CPU: moments, cells and finals."""
    torch.set_num_threads(1)
    res = smt.simulate_stats(
        from_reference(HIST), n, t, seed=SEED,
        strategy=from_reference(_strategy("fixed_amount")),
        target_amount=TARGET, keep_final_values=True, mesh=mesh,
        options=smt.EngineOptions(chunk_paths=8192, **XLA))
    m = res.moments
    return dict(moments=np.array([m.n, m.mean, m.std, m.min, m.max,
                                  m.count_below, m.total_withdrawn]),
                hist=res.histogram_counts, finals=res.final_values)


def test_two_rank_mesh_equals_one_process():
    kw = dict(n=4 * 8192 + 777, t=12)
    ranks = run_ranks(2, "test_torch_xla_backend:xla_rank", kw,
                      device="cpu", timeout=120.0)
    n = torch.get_num_threads()
    try:
        single = xla_rank(None, **kw)
    finally:
        torch.set_num_threads(n)
    for got in ranks:
        for k, v in single.items():
            assert got[k].tobytes() == np.asarray(v).tobytes(), k


class _Stop(Exception):
    pass


def _stats(model, n, t, **kw):
    return smt.simulate_stats(model, n, t, seed=3, target_amount=1200.0,
                              **kw)


@pytest.mark.parametrize("terminal_law", (False, True))
def test_checkpoint_resume_equals_uninterrupted(tmp_path, terminal_law):
    model = from_reference(HIST)
    opts = smt.EngineOptions(chunk_paths=8192, terminal_law=terminal_law,
                             **XLA)
    n, t, path = 4 * 8192 + 777, 24, str(tmp_path / "run.npz")
    calls = []

    def interrupt(done, total):
        calls.append(done)
        if len(calls) == 2:
            raise _Stop()

    with pytest.raises(_Stop):
        _stats(model, n, t, options=opts, checkpoint_path=path,
               progress=interrupt)
    resumed = _stats(model, n, t, options=opts, checkpoint_path=path)
    whole = _stats(model, n, t, options=opts)
    assert resumed.moments == whole.moments
    np.testing.assert_array_equal(resumed.histogram_counts,
                                  whole.histogram_counts)
    with np.load(path) as z:
        tag = bytes(z["fingerprint"]).decode()
    assert ckpt.load(path, tag).paths_done == n


@pytest.mark.parametrize("first", ("auto", "xla"))
def test_checkpoint_of_the_other_stream_refuses(tmp_path, first):
    """A checkpoint of the kernels' stream never resumes an XLA run, nor
    the reverse, though every other argument is the same."""
    model = from_reference(HIST)
    path = str(tmp_path / "run.npz")
    other = "xla" if first == "auto" else "auto"
    _stats(model, 2 * 8192, 12, checkpoint_path=path,
           options=smt.EngineOptions(backend=first, device="cpu",
                                     chunk_paths=8192))
    with pytest.raises(ValueError, match="different run"):
        _stats(model, 2 * 8192, 12, checkpoint_path=path,
               options=smt.EngineOptions(backend=other, device="cpu",
                                         chunk_paths=8192))


@pytest.mark.parametrize("kind", ("historical", "gaussian"))
def test_hist_bands_match_jax(kind):
    """Hist bands take the threefry trajectory route under "xla", as
    JAX's do: the cells agree but for values near a cell edge."""
    t, n_bins, n = 6, 128, 8192 + 100
    model, strategy = _model(kind, t), _strategy("fixed_percent")
    want = smmc.simulate_bands(model, n, t, seed=2, strategy=strategy,
                               sample_paths=3, n_bins=n_bins,
                               options=JaxOptions(backend="xla"))
    got = smt.simulate_bands(from_reference(model), n, t, seed=2,
                             strategy=from_reference(strategy),
                             sample_paths=3, n_bins=n_bins,
                             options=smt.EngineOptions(**XLA))
    assert got.mode == want.mode == "hist"
    np.testing.assert_array_equal(got.month_hist.sum(axis=1), n)
    traj = smt.simulate_paths(from_reference(model), n, t, seed=2,
                              strategy=from_reference(strategy),
                              options=smt.EngineOptions(**XLA))
    logv = np.log(traj.astype(np.float64)).T
    x = ((logv - got.centers[:, None]) / got.scales[:, None] + 12.0) \
        * n_bins / 24.0
    near = (np.abs(x - np.round(x)) <= 1e-4).sum(axis=1)
    l1 = np.abs(got.month_hist - want.month_hist).sum(axis=1)
    assert (l1 <= 2 * near).all(), (l1, near)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-4)
    np.testing.assert_allclose(got.sample_paths, want.sample_paths,
                               rtol=2e-6)


def test_cdf_bands_refuse_as_jax_does():
    for simulate, opts, model in (
            (smmc.simulate_bands, JaxOptions(backend="xla"),
             smmc.GaussianReturns()),
            (smt.simulate_bands, smt.EngineOptions(**XLA),
             smt.GaussianReturns())):
        with pytest.raises(ValueError, match="fused Pallas band kernels"):
            simulate(model, 8192, 12, band_mode="cdf", options=opts)


def test_rqmc_passes_the_backend():
    """Replicated RQMC of the Sobol Gaussian model under "xla" draws the
    XLA points: its replicates are the XLA runs', not the kernels'."""
    model = smt.SobolGaussianReturns.create(12)
    est = smt.rqmc_estimate(model, 8192, 12, replicates=2, seed=4,
                            options=smt.EngineOptions(**XLA))
    runs = [smt.simulate_stats(model, 8192, 12, seed=4 + r,
                               options=smt.EngineOptions(**XLA)).mean
            for r in range(2)]
    np.testing.assert_array_equal(est.replicate_means, runs)
    kernels = smt.rqmc_estimate(model, 8192, 12, replicates=2, seed=4,
                                options=smt.EngineOptions(device="cpu"))
    assert not np.array_equal(kernels.replicate_means, runs)


def test_samplers_under_xla_as_jax():
    """Off the kernels every Gaussian runs the month loop's draw, whatever
    gaussian_sampler says; the terminal law stays the law."""
    gauss = smmc.GaussianReturns()
    for sampler in ("icdf", "clt", "clt-prefix"):
        for terminal_law in (False, True):
            for strategy in (smmc.NoWithdrawal(),
                             smmc.FixedPercentWithdrawal(0.4)):
                want = jax_engine._effective_sampler(
                    gauss, strategy, "xla", JaxOptions(
                        backend="xla", gaussian_sampler=sampler,
                        terminal_law=terminal_law))
                got = port_engine._effective_sampler(
                    from_reference(gauss), from_reference(strategy),
                    smt.EngineOptions(backend="xla",
                                      gaussian_sampler=sampler,
                                      terminal_law=terminal_law))
                assert got == want
    assert port_engine.resolve_backend(smt.EngineOptions()) == "pallas"
    assert port_engine.resolve_backend(
        smt.EngineOptions(backend="xla")) == "xla"


def test_segment_keys_match_jax():
    import jax

    for seed in (0, 9, -3):
        for s in range(3):
            key = jax.random.key(seed)
            if s:
                key = jax.random.fold_in(key, port_engine._SEG_FOLD + s)
            want = tuple(int(v) for v in np.asarray(
                jax.random.key_data(key)))
            assert port_engine._segment_key(seed, s) == want


def test_threefry_loop_refuses_on_cpu_launcher():
    """The launcher takes CUDA tensors only; the wrapper takes the plain
    version for CPU tensors (there is no fallback the other way)."""
    with pytest.raises(ValueError, match="no threefry-loop kernel"):
        ce.threefry_loop_launcher(
            None, torch.ones(12), draw="gaussian", key=(0, 1),
            strategy="none", amount=0.0, n_periods=12, tile0=0,
            valid=8192, n_paths=8192, v0=V0, target=TARGET, shift=0.0,
            lo=1.0, log_lo=0.0, inv_w=1.0, hb=4096, with_hist=True,
            keep_finals=False)
