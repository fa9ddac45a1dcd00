"""The port's host helpers against the JAX package's, on the CPU: the normal
functions (``ops/normal.py``), ``utils/io.py``, ``data/_synthetic.py``, the
native binding (``native/``, on a library built once with g++ for this
session, and its Python fallbacks), ``utils/timing.py`` and
``bench/compare.py``. Inputs are made with numpy from a seed. The sweep
(``bench/sweep.py``) runs at tiny sizes and is held to ``bench_all.py``'s
metric names and ``extra`` keys.

Bars: the normal functions agree within 1e-6 relative, or one float32 ulp
where that is larger, for standardised arguments |z| <= 5 (probabilities
down to ~3e-7). Further out both packages round z^2 to float32 inside
exp(-z^2 / 2) (erfc's tail and the density), which moves the value by up
to ~z^2 * 2^-24 relative, and XLA's exp and torch's round apart: the bar
there is max(1e-6, z^2 * 2^-22). ``count_below_clt`` is n times the cdf
and has the cdf's bar (XLA's float32 erfc and torch's differ in the last
bit for about 45 % of arguments, so the counts are not bit-equal). The
truncated cdf's difference of two cdfs is held absolutely, within 1e-6 of
a probability. The C++ Welford merge associates its M2 sum otherwise
than ``welford_combine`` and is held to it within 1e-12 relative. Files,
arrays, the native library's other outputs and the compare verdicts are
equal.
"""

import ast
import filecmp
import json
import os

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_torch import native as port_native
from stock_market_monte_carlo_torch.bench import compare as port_compare
from stock_market_monte_carlo_torch.bench import sweep as port_sweep
from stock_market_monte_carlo_torch.data import _synthetic as port_syn
from stock_market_monte_carlo_torch.data import loader as port_loader
from stock_market_monte_carlo_torch.ops import normal as port_normal
from stock_market_monte_carlo_torch.ops import reductions as port_red
from stock_market_monte_carlo_torch.ops import sobol as port_sobol
from stock_market_monte_carlo_torch.utils import io as port_io
from stock_market_monte_carlo_torch.utils import timing as port_timing
from stock_market_monte_carlo_tpu import native as jax_native
from stock_market_monte_carlo_tpu.bench import compare as jax_compare
from stock_market_monte_carlo_tpu.data import _synthetic as jax_syn
from stock_market_monte_carlo_tpu.ops import normal as jax_normal
from stock_market_monte_carlo_tpu.utils import io as jax_io

F32_TINY = float(np.finfo(np.float32).tiny)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_normal_close(port, ref, z):
    """The module docstring's bar at standardised arguments ``z``."""
    port = _np(port).astype(np.float64)
    ref = _np(ref).astype(np.float64)
    z = np.broadcast_to(np.asarray(z, np.float64), ref.shape)
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    tail = np.where(np.abs(z) <= 5.0, 1e-6, np.maximum(1e-6, z * z * 2.0**-22))
    bar = np.maximum(tail * np.abs(ref), ulp)
    live = np.abs(ref) > F32_TINY
    bad = live & (np.abs(port - ref) > bar)
    assert not bad.any(), (z[bad][:5], port[bad][:5], ref[bad][:5])


def _z_grid(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.linspace(-9, 9, 20001),
                           rng.normal(0, 2.5, 20000)]).astype(np.float32)


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (0.3, 1.7), (-40.0, 9.0)])
def test_normal_cdf_pdf_match_jax(mean, std):
    z = _z_grid()
    x = (z.astype(np.float64) * std + mean).astype(np.float32)
    zz = (x.astype(np.float32) - np.float32(mean)) / np.float32(std)
    _assert_normal_close(port_normal.normal_cdf(torch.from_numpy(x), mean, std),
                         jax_normal.normal_cdf(x, mean, std), zz)
    _assert_normal_close(port_normal.normal_pdf(torch.from_numpy(x), mean, std),
                         jax_normal.normal_pdf(x, mean, std), zz)


def test_abramowitz_stegun_matches_jax():
    d = _z_grid(1)
    _assert_normal_close(port_normal.normal_cdf_abramowitz_stegun(d),
                         jax_normal.normal_cdf_abramowitz_stegun(d), d)


def test_truncated_cdf_matches_jax():
    rng = np.random.default_rng(2)
    mean, std = 1050.0, 180.0
    x = rng.normal(mean, 2 * std, 20000).astype(np.float32)
    for lo in (400.0, 900.0, 1200.0):
        port = _np(port_normal.truncated_normal_cdf_left(
            torch.from_numpy(x), mean, std, lo))
        ref = _np(jax_normal.truncated_normal_cdf_left(x, mean, std, lo))
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)
        assert ((port >= 0) & (port <= 1)).all()


def test_quantiles_and_icdf_match_jax():
    rng = np.random.default_rng(3)
    qs = np.concatenate([[1e-7, 1e-4, 0.01, 0.05, 0.5, 0.95, 0.99, 1 - 1e-4],
                         rng.uniform(0, 1, 5000)]).astype(np.float32)
    for mean, std in ((0.0, 1.0), (1065.0, 177.0)):
        port = port_normal.quantiles_from_mean_std(qs, mean, std)
        ref = jax_normal.quantiles_from_mean_std(qs, mean, std)
        z = (_np(ref).astype(np.float64) - mean) / std
        _assert_normal_close(port, ref, z)


def test_count_below_clt_matches_jax():
    """Python floats, as the CLI passes them: the standardised target in
    float64, one float32 erfc."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        mean = float(rng.uniform(500, 3000))
        std = float(rng.uniform(10, 900))
        n = int(rng.integers(1, 10**9))
        target = float(rng.uniform(0, 4000))
        z = (target - mean) / std
        port = port_normal.count_below_clt(target, mean, std, n)
        ref = jax_normal.count_below_clt(target, mean, std, n)
        assert port.dtype == torch.float32
        _assert_normal_close(port, ref, z)


# ---------------------------------------------------------------------------
# The native library: built once, loaded by both bindings.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="session")
def native_lib(tmp_path_factory):
    return port_native.build(out=tmp_path_factory.mktemp("native")
                             / "libsmmc_native.so")


@pytest.fixture
def bindings(monkeypatch, native_lib):
    """Both bindings loading ``native_lib`` (through $SMMC_NATIVE_LIB);
    their caches are restored afterwards."""
    monkeypatch.setenv("SMMC_NATIVE_LIB", str(native_lib))
    for mod in (port_native, jax_native):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_LOAD_ATTEMPTED", False)
    assert port_native.available() and jax_native.available()
    return port_native, jax_native


@pytest.fixture
def no_native(monkeypatch, tmp_path):
    """Neither binding finds a library: the Python fallbacks."""
    monkeypatch.setenv("SMMC_NATIVE_LIB", str(tmp_path / "missing.so"))
    monkeypatch.setattr(port_native, "LIBRARY", tmp_path / "missing.so")
    for mod in (port_native, jax_native):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_LOAD_ATTEMPTED", True)
    assert not port_native.available()


def test_build_command_is_the_makefile_s():
    assert port_native.CXX_FLAGS == ("-O3", "-std=c++20", "-fPIC", "-shared")
    assert port_native.SOURCE.name == "smmc_native.cpp"
    assert port_native.SOURCE.is_file()


@pytest.mark.parametrize("table", ["synthetic", "hostile", "garbage"])
def test_native_reader_matches_jax_and_python(bindings, tmp_path, table):
    port, jax_ = bindings
    if table == "garbage":
        path = tmp_path / "r.csv"
        path.write_text("Date,returns\n1928-01,\n1928-02,1.5\n1928-03,nan\n"
                        "1928-04,-2.25\n")
        path = str(path)
    else:
        path = (port_loader.SYNTHETIC_CSV if table == "synthetic"
                else port_loader.HOSTILE_CSV)
    got = port.native_read_returns(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_.native_read_returns(path))
    # the loader takes the native route here and the Python one without it
    np.testing.assert_array_equal(port_loader.read_historical_returns(path),
                                  got)
    port._LIB, port._LOAD_ATTEMPTED = None, True
    assert port.native_read_returns(path) is None
    np.testing.assert_array_equal(port_loader.read_historical_returns(path),
                                  got)


def test_native_reader_missing_column(bindings, tmp_path):
    path = tmp_path / "r.csv"
    path.write_text("Date,foo\n1,2\n")
    with pytest.raises(IOError):
        bindings[0].native_read_returns(str(path))
    with pytest.raises(ValueError, match="no 'returns' column"):
        port_loader.read_historical_returns(str(path))


def test_native_welford_matches_jax_and_python(bindings):
    port, jax_ = bindings
    rng = np.random.default_rng(5)
    a = rng.normal(3, 2, 1000)
    b = rng.normal(5, 1, 2345)
    sa = np.asarray([a.size, a.mean(), ((a - a.mean()) ** 2).sum()])
    sb = np.asarray([b.size, b.mean(), ((b - b.mean()) ** 2).sum()])
    got = port.native_welford_merge(sa.copy(), sb)
    np.testing.assert_array_equal(got, jax_.native_welford_merge(sa.copy(),
                                                                 sb))
    n, mean, m2 = port_red.welford_combine(
        torch.as_tensor(sa, dtype=torch.float64),
        torch.as_tensor(sb, dtype=torch.float64))
    # the C++ merge adds m2a + (m2b + d^2 w), welford_combine
    # (m2a + m2b) + d^2 w: a few float64 ulps apart
    assert got[0] == float(n)
    np.testing.assert_allclose(got, [float(n), float(mean), float(m2)],
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("offset", [0, 1, 1000, 123457, 2**32 - 64])
def test_native_sobol_matches_jax_and_python(bindings, offset):
    port, jax_ = bindings
    dims = 7
    d = port_sobol.direction_numbers(dims)
    got = port.native_sobol_points(d, offset, 64)
    np.testing.assert_array_equal(got, jax_.native_sobol_points(d, offset,
                                                                64))
    words = port_sobol.sobol_bits_u32(d, offset, 64, dims).numpy()
    np.testing.assert_array_equal(got, words.astype(np.float64) * 2.0**-32)


@pytest.mark.parametrize("offset", [0, 2**33 + 777])
def test_native_sobol_bits64_matches_jax_and_python(bindings, offset):
    port, jax_ = bindings
    dims = 5
    d64 = port_sobol.direction_numbers_u64(dims)
    got = port.native_sobol_bits64(d64, offset, 32)
    np.testing.assert_array_equal(got, jax_.native_sobol_bits64(d64, offset,
                                                                32))
    dir_hi, dir_lo = port_sobol.direction_numbers_split(dims)
    lo, hi = port_sobol._split_index64(offset, 0, 32, torch.device("cpu"))
    w_hi, w_lo = port_sobol.sobol_bits64_pair(
        torch.as_tensor(dir_hi.astype(np.int64)),
        torch.as_tensor(dir_lo.astype(np.int64)), lo, hi)
    words = (w_hi.numpy().astype(np.uint64) << np.uint64(32)) | \
        w_lo.numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, words)


def test_python_fallbacks(no_native):
    assert port_native.native_read_returns(port_loader.SYNTHETIC_CSV) is None
    assert port_native.native_sobol_points(
        port_sobol.direction_numbers(3), 0, 4) is None
    assert port_native.native_sobol_bits64(
        port_sobol.direction_numbers_u64(3), 0, 4) is None
    assert port_native.native_write_data_file("x.csv", np.zeros(1),
                                              np.zeros(2)) is False
    with pytest.raises(RuntimeError, match="not built"):
        port_native.native_welford_merge(np.zeros(3), np.zeros(3))


# ---------------------------------------------------------------------------
# utils/io and data/_synthetic.
# ---------------------------------------------------------------------------


def _sim_row(seed):
    rng = np.random.default_rng(seed)
    values = (1000.0 * np.cumprod(1 + rng.normal(0.005, 0.04, 361))
              ).astype(np.float32)
    values[7] = 1e-30          # a depleted month: %g's exponent form
    returns = (values[1:] / values[:-1] - 1.0) * 100.0
    return returns, values


@pytest.mark.parametrize("route", ["native", "python"])
def test_write_data_file_bytes_match_jax(request, tmp_path, capsys, route):
    request.getfixturevalue("bindings" if route == "native" else "no_native")
    returns, values = _sim_row(6)
    p = port_io.write_data_file("sim.csv", returns, values,
                                out_dir=str(tmp_path / "port"))
    j = jax_io.write_data_file("sim.csv", returns, values,
                               out_dir=str(tmp_path / "jax"))
    out = capsys.readouterr().out.splitlines()
    assert out == [f"Writing data to csv file {p}",
                   f"Writing data to csv file {j}"]
    assert filecmp.cmp(p, j, shallow=False)
    back_r, back_v = port_io.read_data_file(p)
    jr, jv = jax_io.read_data_file(p)
    np.testing.assert_array_equal(back_r, jr)
    np.testing.assert_array_equal(back_v, jv)
    np.testing.assert_allclose(back_v, values, rtol=1e-5)


def test_vector_helpers_match_jax(tmp_path, capsys):
    v = np.random.default_rng(7).normal(0, 100, 33)
    port_io.print_vector(v)
    jax_io.print_vector(v)
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line
    port_io.write_vector_file(str(tmp_path / "a.txt"), v)
    jax_io.write_vector_file(str(tmp_path / "b.txt"), v)
    assert filecmp.cmp(tmp_path / "a.txt", tmp_path / "b.txt", shallow=False)


def test_synthetic_tables_match_jax_and_the_vendored_files(tmp_path):
    np.testing.assert_array_equal(port_syn.synthetic_monthly_returns(),
                                  jax_syn.synthetic_monthly_returns())
    for n in (3, 97, 128, 1000):
        np.testing.assert_array_equal(port_syn.hostile_monthly_returns(n),
                                      jax_syn.hostile_monthly_returns(n))
    with pytest.raises(ValueError):
        port_syn.hostile_monthly_returns(2)
    port_syn.write_csv(str(tmp_path / "syn.csv"))
    port_syn.write_hostile_csv(str(tmp_path / "hostile.csv"))
    jax_syn.write_csv(str(tmp_path / "syn_jax.csv"))
    for ours, vendored in (("syn.csv", port_loader.SYNTHETIC_CSV),
                           ("hostile.csv", port_loader.HOSTILE_CSV),
                           ("syn_jax.csv", port_loader.SYNTHETIC_CSV)):
        assert filecmp.cmp(tmp_path / ours, vendored, shallow=False), ours


def test_fetch_refuses_without_yfinance(monkeypatch):
    import builtins

    from stock_market_monte_carlo_torch.data import fetch

    real = builtins.__import__

    def no_yf(name, *a, **k):
        if name == "yfinance":
            raise ImportError("no yfinance")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_yf)
    with pytest.raises(SystemExit, match="yfinance is not installed"):
        fetch.fetch_sp500(out_csv="never_written.csv")
    assert not os.path.exists("never_written.csv")


# ---------------------------------------------------------------------------
# utils/timing.
# ---------------------------------------------------------------------------


def test_phase_timer_and_time_fn_on_the_cpu(capsys, tmp_path):
    pt = port_timing.PhaseTimer()
    x = torch.arange(1 << 16, dtype=torch.float32)
    with pt.phase("square", x):
        y = x * x
    with pt.phase("sum", [y, {"s": y.sum()}], None):
        pass
    with pt.phase("square"):
        pass
    totals = pt.totals()
    assert list(totals) == ["square", "sum"]
    assert all(v >= 0 for v in totals.values())
    lines = pt.report().splitlines()
    assert lines[0].startswith("phase") and lines[-1].startswith("TOTAL")
    assert len(lines) == 4
    best = port_timing.time_fn(torch.cumsum, x, 0, reps=2, label="cumsum")
    assert best > 0
    assert capsys.readouterr().out.startswith("cumsum: ")
    with port_timing.trace(str(tmp_path / "tr")) as prof:
        torch.ones(16).sum()
    assert prof is not None
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


# ---------------------------------------------------------------------------
# bench/compare.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["separated", "identical", "ties", "flat",
                                  "random"])
def test_mann_whitney_u_matches_jax(case):
    rng = np.random.default_rng(8)
    xs, ys = {
        "separated": ([1.0, 2.0, 3.0, 4.0, 5.0], [6.0, 7.0, 8.0, 9.0, 10.0]),
        "identical": (list(rng.normal(10, 1, 30)),) * 2,
        "ties": ([1.0, 1.0, 2.0], [1.0, 2.0, 2.0]),
        "flat": ([3.0] * 5, [3.0] * 5),
        "random": (list(np.round(rng.normal(1.0, 0.05, 17), 2)),
                   list(np.round(rng.normal(1.02, 0.05, 11), 2))),
    }[case]
    assert port_compare.mann_whitney_u(xs, ys) == \
        jax_compare.mann_whitney_u(xs, ys)


def _bench_file(path, name, samples, unit="s", aggregates=True):
    entries = [{"name": name, "run_type": "iteration",
                "repetition_index": i, "real_time": float(t),
                "time_unit": unit} for i, t in enumerate(samples)]
    if aggregates:
        entries.append({"name": f"{name}_median", "run_type": "aggregate",
                        "aggregate_name": "median",
                        "real_time": float(np.median(samples)),
                        "time_unit": unit})
    path.write_text(json.dumps({"benchmarks": entries}))
    return str(path)


@pytest.mark.parametrize("case", ["faster", "same", "single", "reps_only",
                                  "ns_unit", "missing"])
def test_compare_files_gives_jax_s_verdicts(tmp_path, capsys, case):
    rng = np.random.default_rng(9)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    if case == "faster":
        _bench_file(a, "mc/360/1000000", rng.normal(1.0, 0.01, 10))
        _bench_file(b, "mc/360/1000000", rng.normal(0.5, 0.01, 10))
    elif case == "same":
        s = rng.normal(1.0, 0.01, 10)
        _bench_file(a, "mc/12/20000", s)
        _bench_file(b, "mc/12/20000", s)
    elif case == "single":
        for p, t in ((a, 2.0), (b, 1.0)):
            p.write_text(json.dumps({"benchmarks": [{
                "name": "mc/12/1000", "real_time": t,
                "real_time_median": t, "time_unit": "s",
                "repetitions": 3}]}))
    elif case == "reps_only":
        _bench_file(a, "mc/1/1", [9.0, 1.0, 1.1], aggregates=False)
        _bench_file(b, "mc/1/1", [9.0, 1.0, 1.2], aggregates=False)
    elif case == "ns_unit":
        _bench_file(a, "mc/1/1", rng.normal(1e9, 1e7, 5), unit="ns")
        _bench_file(b, "mc/1/1", rng.normal(0.9, 0.01, 5))
    else:
        _bench_file(a, "mc/1/1", [1.0, 1.1])
        _bench_file(b, "mc/2/2", [1.0, 1.1])
    port_rows = port_compare.compare_files(str(a), str(b))
    port_out = capsys.readouterr().out
    jax_rows = jax_compare.compare_files(str(a), str(b))
    jax_out = capsys.readouterr().out
    assert port_rows == jax_rows
    assert port_out == jax_out


def test_plot_metric_groups_match_jax(tmp_path):
    path = tmp_path / "m.json"
    entries = [{"name": f"{lbl}/{size}", "real_time": t,
                "iterations": 3}
               for lbl, k in (("law", 1.0), ("loop", 3.0))
               for size, t in ((1024, k), (4096, 3 * k), (16384, 9 * k))]
    path.write_text(json.dumps({"benchmarks": entries}))
    kw = dict(metric="real_time", transform="inverse", relative_to="law",
              logx=True, logy=True)
    port = port_compare.plot_metric(str(path), output=str(tmp_path / "p.png"),
                                    **kw)
    ref = jax_compare.plot_metric(str(path), output=str(tmp_path / "j.png"),
                                  **kw)
    assert port == ref
    assert (tmp_path / "p.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# bench/sweep.
# ---------------------------------------------------------------------------

BENCH_ALL = os.path.join(os.path.dirname(__file__), os.pardir, "bench_all.py")


def _bench_all_records():
    """bench_all.py's lines in source order: (metric, extra keys), read
    from its ``_line`` calls, the loop's f-string expanded over the loop's
    names."""
    with open(BENCH_ALL) as f:
        tree = ast.parse(f.read())

    def keys(call):
        extra = [k.value for k in call.args[4].keys] if len(call.args) > 4 \
            else []
        return ["n_paths", "n_periods", "elapsed_s", *extra]

    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.For):
            names = [e.elts[0].value for e in node.iter.elts]
            for call in ast.walk(node):
                if isinstance(call, ast.Call) and \
                        getattr(call.func, "id", None) == "_line":
                    prefix = call.args[0].values[0].value
                    found += [(call.lineno, i, prefix + n, keys(call))
                              for i, n in enumerate(names)]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "_line" and \
                isinstance(node.args[0], ast.Constant):
            found.append((node.lineno, 0, node.args[0].value, keys(node)))
    return [(name, k) for _, _, name, k in sorted(found)]


def test_sweep_prints_bench_all_s_lines(monkeypatch, capsys):
    """Every config at tiny sizes on the CPU: nine records (config 7 on
    every device), in bench_all.py's order, with its metric names and
    extra keys; each printed line is its returned record."""
    for name, value in (("MONTHS", 12), ("QMC_MONTHS", 12), ("PATHS", 4096),
                        ("TRAJECTORIES", (128, 64)), ("QMC_PATHS", 4096),
                        ("FUSED_PATHS", (16384, 8192)),
                        ("BAND_PATHS", (8192, 4096))):
        monkeypatch.setattr(port_sweep, name, value)
    records = port_sweep.main(["--quick", "--device", "cpu"])
    printed = [json.loads(line)
               for line in capsys.readouterr().out.splitlines()]
    assert printed == records
    want = _bench_all_records()
    assert len(want) == 9
    assert [(r["metric"], list(r["extra"])) for r in records] == want
    for r in records:
        assert r["unit"] == "paths/s" and r["value"] > 0
        assert r["extra"]["n_periods"] == 12
    assert [r["extra"]["n_paths"] for r in records] == \
        [4096, 4096, 64, 4096, 8192, 4096, 4096, 8192, 8192]
