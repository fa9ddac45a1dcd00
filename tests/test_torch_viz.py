"""The port's ``viz/`` against the JAX package's, headless on Agg, on the CPU.

- ``fan_chart``, ``band_chart``, ``rng_histograms`` and
  ``distribution_curves`` draw the same lines and histograms as the JAX
  package's for the same inputs (every drawing call recorded): exactly,
  but for the normal curves, which hold the bar of
  tests/test_torch_surfaces.py (1e-6 relative or one float32 ulp).
- ``LiveDashboard`` and ``query_loop`` print the same text for equal
  ``StreamUpdate``s; ``InteractiveWindow``'s slider recompute equals the
  histogram oracle, as tests/test_gui.py checks; ``LiveFanFigure`` draws
  the run's stream rows; ``DemoWindow``'s widgets rerun its simulation.
"""

import io

import matplotlib

matplotlib.use("Agg")

import matplotlib.axes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_cpu_share  # noqa: F401, E402

import stock_market_monte_carlo_torch as smt  # noqa: E402
from stock_market_monte_carlo_torch.ops import reductions as port_red  # noqa: E402
from stock_market_monte_carlo_torch.viz import live as port_live  # noqa: E402
from stock_market_monte_carlo_torch.viz import plots as port_plots  # noqa: E402
from stock_market_monte_carlo_tpu.engine.engine import (  # noqa: E402
    StreamUpdate as JaxUpdate,
)
from stock_market_monte_carlo_tpu.ops import reductions as jax_red  # noqa: E402
from stock_market_monte_carlo_tpu.viz import live as jax_live  # noqa: E402
from stock_market_monte_carlo_tpu.viz import plots as jax_plots  # noqa: E402
from test_torch_surfaces import _assert_normal_close  # noqa: E402

CPU = smt.EngineOptions(device="cpu", chunk_paths=8192)
DRAWN = ("plot", "hist", "barh", "bar", "fill_between", "axhline")


@pytest.fixture
def drawn(monkeypatch):
    """Every drawing call on an Axes: (method, numeric arguments as
    float64 arrays, label)."""
    calls = []
    for name in DRAWN:
        real = getattr(matplotlib.axes.Axes, name)

        def rec(self, *a, _real=real, _name=name, **k):
            nums = [np.asarray(x, np.float64) for x in a
                    if not isinstance(x, str)]
            if "height" in k:
                nums.append(np.asarray(k["height"], np.float64))
            calls.append((_name, nums, k.get("label")))
            return _real(self, *a, **k)

        monkeypatch.setattr(matplotlib.axes.Axes, name, rec)
    return calls


def _take(calls):
    out = list(calls)
    calls.clear()
    return out


def _assert_same_drawing(port, ref):
    assert [(m, len(n), lbl) for m, n, lbl in port] == \
        [(m, len(n), lbl) for m, n, lbl in ref]
    for (m, p_nums, _), (_, r_nums, _) in zip(port, ref):
        for p, r in zip(p_nums, r_nums):
            np.testing.assert_array_equal(p, r, err_msg=m)


def test_fan_chart_draws_as_jax(drawn, tmp_path):
    rng = np.random.default_rng(0)
    traj = (1000 * np.cumprod(1 + rng.normal(0.004, 0.04, (7, 25)), axis=1)
            ).astype(np.float32)
    edges = np.geomspace(500, 3000, 33)
    counts = rng.integers(0, 100, 32).astype(np.float64)
    curve = (0.5 * (edges[1:] + edges[:-1]), rng.uniform(0, 50, 32))
    for mod in (port_plots, jax_plots):
        mod.fan_chart(traj, target=1100.0, histogram=(edges, counts),
                      normal_curve=curve, save=str(tmp_path / "f.png"))
    calls = _take(drawn)
    _assert_same_drawing(calls[:len(calls) // 2], calls[len(calls) // 2:])
    assert (tmp_path / "f.png").exists()


def test_band_chart_draws_as_jax(drawn, tmp_path):
    bands = smt.simulate_bands(smt.GaussianReturns(), 8192, 6, seed=1,
                               sample_paths=4, options=CPU)
    port_plots.band_chart(bands, target=1050.0,
                          save=str(tmp_path / "p" / "b.png"))
    port = _take(drawn)
    jax_plots.band_chart(bands, target=1050.0, save=str(tmp_path / "j.png"))
    _assert_same_drawing(port, _take(drawn))
    assert [m for m, _, _ in port].count("fill_between") == 2
    assert (tmp_path / "p" / "b.png").exists()


def test_rng_histograms_draw_as_jax(drawn, tmp_path):
    port_plots.rng_histograms(save=str(tmp_path / "p.png"), n=4096,
                              device="cpu")
    port = _take(drawn)
    jax_plots.rng_histograms(save=str(tmp_path / "j.png"), n=4096)
    ref = _take(drawn)
    _assert_same_drawing(port, ref)
    # Axes.hist draws its bars through Axes.bar
    assert [m for m, _, _ in port if m != "bar"] == ["hist", "axhline"] * 3


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (1000.0, 150.0)])
def test_distribution_curves_draw_as_jax(drawn, tmp_path, mean, std):
    port_plots.distribution_curves(mean, std, save=str(tmp_path / "p.png"),
                                   device="cpu")
    port = _take(drawn)
    jax_plots.distribution_curves(mean, std, save=str(tmp_path / "j.png"))
    ref = _take(drawn)
    assert [m for m, _, _ in port] == [m for m, _, _ in ref] == ["plot"] * 3
    for i, ((_, (px, py), _), (_, (rx, ry), _)) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(px, rx)
        z = (rx - mean) / std if i < 2 else (ry - mean) / std
        _assert_normal_close(py, ry, z)


@pytest.mark.parametrize("plot", ["rng_histograms", "distribution_curves"])
def test_curves_default_to_the_card(monkeypatch, tmp_path, plot):
    """With no device named, the curves are drawn on the card; without one
    they refuse, and never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        getattr(port_plots, plot)(save=str(tmp_path / "x.png"))
    assert not (tmp_path / "x.png").exists()


# ---------------------------------------------------------------------------
# The live surfaces.
# ---------------------------------------------------------------------------


def _updates(n_chunks=3, months=12, target=1100.0):
    """The port's stream of a run, and JAX StreamUpdates with the same
    numbers (each package's own HistogramSpec)."""
    port = []
    smt.simulate_stats(smt.GaussianReturns(), n_chunks * 8192, months,
                       seed=3, target_amount=target, options=CPU,
                       stream=port.append)
    jax = [JaxUpdate(done=u.done, n_paths=u.n_paths, stats=u.stats.copy(),
                     hist=u.hist.copy(),
                     spec=jax_red.HistogramSpec(u.spec.lo, u.spec.hi,
                                                u.spec.n_bins),
                     target_amount=u.target_amount, elapsed_s=u.elapsed_s)
           for u in port]
    return port, jax


@pytest.fixture(scope="module")
def streams():
    return _updates()


def test_stream_updates_are_exact_partials(streams):
    port, _ = streams
    assert [u.done for u in port] == [8192, 16384, 24576]
    for u in port:
        assert u.hist.sum() == u.done and u.moments.n == u.done


def test_dashboard_prints_as_jax(streams):
    port_out, jax_out = io.StringIO(), io.StringIO()
    port_dash = port_live.LiveDashboard(out=port_out, min_interval_s=0.0)
    jax_dash = jax_live.LiveDashboard(out=jax_out, min_interval_s=0.0)
    for p, j in zip(*streams):
        port_dash(p)
        jax_dash(j)
    assert port_dash.frames == jax_dash.frames == 3
    assert port_out.getvalue() == jax_out.getvalue()
    assert "P(final < 1,100.0)" in port_out.getvalue()


def test_query_loop_prints_as_jax(streams):
    commands = "1100\n900\nq 0.5\nq 2\nhist\nstats\nhelp\nabc\nquit\n"
    texts = []
    for mod, u in ((port_live, streams[0][-1]), (jax_live, streams[1][-1])):
        out = io.StringIO()
        mod.query_loop(u, inp=io.StringIO(commands), out=out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert "P(final < 1,100.00)" in texts[0]


def test_histogram_helpers_match_jax():
    rng = np.random.default_rng(4)
    counts = np.zeros(4096)
    counts[1000:1333] = rng.integers(0, 50, 333)
    port_spec = port_red.HistogramSpec(10.0, 1e6, 4094)
    jax_spec = jax_red.HistogramSpec(10.0, 1e6, 4094)
    np.testing.assert_array_equal(port_spec.edges(), jax_spec.edges())
    pc, pe = port_live.trim_histogram(counts, port_spec)
    jc, je = jax_live.trim_histogram(counts, jax_spec)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pe, je)
    for target in (16, 128, 1000):
        for a, b in zip(port_live.downsample_histogram(pc, pe, target),
                        jax_live.downsample_histogram(jc, je, target)):
            np.testing.assert_array_equal(a, b)
    assert port_live.unicode_histogram(pc) == jax_live.unicode_histogram(jc)
    assert port_live.trim_histogram(np.zeros(4096), port_spec) == (None,
                                                                    None)


def test_result_query_answers_as_the_stream_does(streams):
    u = streams[0][-1]
    res = smt.simulate_stats(smt.GaussianReturns(), 3 * 8192, 12, seed=3,
                             target_amount=1100.0, options=CPU)
    q = port_live.ResultQuery(res)
    np.testing.assert_array_equal(q.hist, u.hist)
    assert q.prob_below(1050.0) == u.prob_below(1050.0)
    np.testing.assert_array_equal(q.quantiles([0.1, 0.9]),
                                  u.quantiles([0.1, 0.9]))


@pytest.fixture(scope="module")
def window_after_run():
    from stock_market_monte_carlo_torch.viz.gui import InteractiveWindow

    model = smt.GaussianReturns()
    win = InteractiveWindow(model, 6, target=1000.0, n_curves=7,
                            options=CPU)
    res = smt.run(model, 2 * 8192, 6, seed=3, target_amount=1000.0,
                  options=CPU, stream=win)
    yield win, res
    win.close()


def test_window_builds_and_streams(window_after_run):
    win, res = window_after_run
    assert win.frames >= 1
    assert win.last_update.done == res.n_paths
    assert win.curves_done == 7
    assert win.slider is not None
    win.show()          # headless: returns


@pytest.mark.parametrize("new_target", [500.0, 1066.0, 9000.0])
def test_slider_change_recomputes_prob_below(window_after_run, new_target):
    win, _ = window_after_run
    u = win.last_update
    win.slider.set_val(new_target)        # fires on_changed, as a drag
    eff = win.target
    assert eff == pytest.approx(new_target, abs=win.slider.valstep)
    want = port_red.prob_below_from_histogram(u.spec, u.hist, eff)
    assert win.prob_below_target() == want
    assert f"{100.0 * want:.4f}%" in win._prob_text.get_text()


def test_live_fan_draws_the_stream_rows(drawn, tmp_path):
    from stock_market_monte_carlo_torch.viz.live_fan import (
        FanoutStream,
        LiveFanFigure,
    )

    model = smt.HistoricalBootstrap.from_csv()
    fan = LiveFanFigure(model, 3, seed=2, target=1000.0, n_curves=5,
                        out_path=str(tmp_path / "fan.png"),
                        frames_dir=str(tmp_path / "frames"),
                        curves_per_frame=3, min_interval_s=0.0,
                        options=CPU)
    seen = []
    smt.simulate_stats(model, 2 * 8192, 3, seed=2, options=CPU,
                       stream=FanoutStream(fan, seen.append))
    fan.close()
    assert len(seen) == 2 and fan.frames == 2 and fan.curves_done == 5
    assert sorted(p.name for p in (tmp_path / "frames").iterdir()) == [
        f"frame_{i:04d}.png" for i in range(2)]
    curves = [n[0] for m, n, _ in drawn if m == "plot"]
    rows = np.concatenate([c.T for c in curves])
    np.testing.assert_array_equal(
        rows, smt.simulate_paths(model, 5, 3, seed=2, options=CPU))


def test_demo_window_widgets_rerun():
    from stock_market_monte_carlo_torch.viz.demo import DemoWindow

    win = DemoWindow(options=CPU)
    try:
        assert win.model_kind == "gaussian" and int(win.slider.val) == 60
        win.slider.set_val(6)
        direct = smt.simulate_stats(smt.GaussianReturns(), 8192, 6, seed=0,
                                    options=CPU)
        assert win.result.moments == direct.moments
        win._on_click(None)
        assert win.seed == 1 and win.clicks == 1
        win._on_model("historical")
        direct = smt.simulate_stats(smt.HistoricalBootstrap.from_csv(),
                                    8192, 6, seed=1, options=CPU)
        assert win.result.moments == direct.moments
        win.check.set_active(0)
        assert win.show_hist is False
        assert "hist off" in win.status.get_text()
    finally:
        win.close()


def test_plots_need_matplotlib(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name == "matplotlib":
            raise ImportError("no matplotlib")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="need matplotlib"):
        port_plots.distribution_curves()
