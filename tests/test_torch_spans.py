"""The port's program spans (``utils/timing.py``) on the CPU: a span with
no profiler enters no ``record_function``; under ``torch.profiler`` the
two entry points, ``simulate_stats`` and ``simulate_bands``, record
exactly the documented spans, each nested in its entry span, at the
documented counts, and return the same results bit for bit as without a
profiler. A terminal-law run adds its operand's span inside
``smmc.prepare``, and the fit's inside that on a fit cache miss."""

import json

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.utils import timing

# three chunks of one 8192-path tile, the last ragged
N_PATHS, N_PERIODS, CHUNK = 20000, 12, 8192
N_CHUNKS = 3
CPU = smt.EngineOptions(device="cpu", chunk_paths=CHUNK)


class _Counting:
    """A stand-in for ``torch.profiler.record_function`` that counts its
    entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def _table():
    rng = np.random.default_rng(7)
    return rng.normal(0.7, 4.0, 600).astype(np.float32)


def _spans(trace_dir):
    """(name, start, end) of the trace's program spans, by start."""
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e.get("name", "").startswith("smmc.")]
    return sorted(out, key=lambda s: s[1])


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    assert not torch._C._autograd._profiler_enabled()
    a, b = timing.span("smmc.a"), timing.span("smmc.b")
    assert a is b  # one shared no-op: nothing made a call
    with a:
        with b:
            pass
    smt.simulate_stats(smt.GaussianReturns(), N_PATHS, N_PERIODS, seed=3,
                       options=CPU)
    smt.simulate_bands(smt.GaussianReturns(), N_PATHS, N_PERIODS, seed=3,
                       band_mode="cdf", options=CPU)
    assert _Counting.entered == 0


def test_span_nests_under_a_profiler(tmp_path):
    with timing.trace(str(tmp_path)):
        with timing.span("smmc.outer"):
            with timing.span("smmc.inner"):
                torch.ones(8).sum()

        @timing.spanned("smmc.decorated")
        def twice(x):
            return 2 * x

        assert twice(21) == 42
    spans = _spans(tmp_path)
    assert [n for n, _, _ in spans] == ["smmc.outer", "smmc.inner",
                                        "smmc.decorated"]
    (_, os_, oe), (_, is_, ie) = spans[:2]
    assert os_ <= is_ and ie <= oe
    assert spans[2][1] >= oe


def _stats_of(res):
    m = res.moments
    return (m.n, m.mean, m.std, m.min, m.max, m.count_below,
            res.histogram_counts.tolist())


def _stats(**kw):
    return _stats_of(smt.simulate_stats(
        smt.HistoricalBootstrap(_table()), N_PATHS, N_PERIODS, seed=11,
        target_amount=1500.0, options=CPU, **kw))


def _bands(mode, strategy=smt.NoWithdrawal()):
    res = smt.simulate_bands(smt.HistoricalBootstrap(_table()), N_PATHS,
                             N_PERIODS, seed=5, band_mode=mode,
                             strategy=strategy, sample_paths=4, n_bins=64,
                             options=CPU)
    return (res.values.tolist(), res.month_hist.tolist(),
            res.sample_paths.tolist())


# (run, entry span, {span: count}); absorbs: the stats run's deferred
# chunks are fetched and merged once, a run with a progress callback and
# the bands loop absorb every chunk
CASES = {
    "stats": (_stats, "smmc.simulate_stats",
              {"smmc.prepare": 1, "smmc.dispatch": N_CHUNKS,
               "smmc.wait": 1, "smmc.merge": 1}),
    "stats_progress": (lambda: _stats(progress=lambda done, n: None),
                       "smmc.simulate_stats",
                       {"smmc.prepare": 1, "smmc.dispatch": N_CHUNKS,
                        "smmc.wait": N_CHUNKS, "smmc.merge": N_CHUNKS}),
    "bands_hist": (lambda: _bands("hist"), "smmc.simulate_bands",
                   {"smmc.prepare": 1, "smmc.dispatch": N_CHUNKS,
                    "smmc.wait": N_CHUNKS, "smmc.merge": N_CHUNKS,
                    "smmc.invert": 1, "smmc.sample_paths": 1}),
    "bands_cdf": (lambda: _bands("cdf"), "smmc.simulate_bands",
                  {"smmc.prepare": 1, "smmc.dispatch": N_CHUNKS,
                   "smmc.wait": N_CHUNKS, "smmc.merge": N_CHUNKS,
                   "smmc.invert": 1, "smmc.sample_paths": 1}),
    # the trajectory route, on the linear grid
    "bands_fixed_amount": (
        lambda: _bands("hist", smt.FixedAmountWithdrawal(2.0)),
        "smmc.simulate_bands",
        {"smmc.prepare": 1, "smmc.dispatch": N_CHUNKS,
         "smmc.wait": N_CHUNKS, "smmc.merge": N_CHUNKS, "smmc.invert": 1,
         "smmc.sample_paths": 1}),
    "bands_analytic": (lambda: _bands("analytic"), "smmc.simulate_bands",
                       {"smmc.invert": 1, "smmc.sample_paths": 1}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_entry_spans_on_the_cpu(case, tmp_path):
    run, entry, counts = CASES[case]
    off = run()
    with timing.trace(str(tmp_path)):
        on = run()
    assert on == off  # bit for bit with the profiler on
    spans = _spans(tmp_path)
    names = [n for n, _, _ in spans]
    assert names[0] == entry and names.count(entry) == 1
    got = {n: names.count(n) for n in set(names) - {entry}}
    assert got == counts
    _, lo, hi = spans[0]
    for name, s, e in spans[1:]:
        assert lo <= s <= e <= hi, name
    # the children follow one another: no two overlap
    for (_, _, e0), (_, s1, _) in zip(spans[1:], spans[2:]):
        assert e0 <= s1


def _law_stats(backend):
    options = smt.EngineOptions(device="cpu", chunk_paths=CHUNK,
                                terminal_law=True, backend=backend)
    return _stats_of(smt.simulate_stats(
        smt.GaussianReturns(), N_PATHS, N_PERIODS, seed=13,
        target_amount=1100.0, options=options))


def _inside(spans, inner, outer):
    """Each ``inner`` span lies inside an ``outer`` span."""
    outers = [(s, e) for n, s, e in spans if n == outer]
    return all(any(os_ <= s <= e <= oe for os_, oe in outers)
               for n, s, e in spans if n == inner)


# the counter law's kernel route and the XLA backend's threefry law: both
# take their operand from engine._law_operand
@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_law_spans_on_the_cpu(backend, tmp_path, monkeypatch):
    from stock_market_monte_carlo_torch.ops import terminal_law

    monkeypatch.setattr(terminal_law, "_FIT_CACHE", {})
    off = _law_stats(backend)  # fits without a profiler
    for name, cached in (("cached", True), ("new", False)):
        if not cached:
            monkeypatch.setattr(terminal_law, "_FIT_CACHE", {})
        with timing.trace(str(tmp_path / name)):
            on = _law_stats(backend)
        assert on == off  # bit for bit with the profiler on
        spans = _spans(tmp_path / name)
        names = [n for n, _, _ in spans]
        assert names.count("smmc.prepare") == 1
        assert names.count("smmc.law_operand") == 1
        assert names.count("smmc.law_fit") == (0 if cached else 1)
        assert _inside(spans, "smmc.law_operand", "smmc.prepare")
        assert _inside(spans, "smmc.law_fit", "smmc.law_operand")
