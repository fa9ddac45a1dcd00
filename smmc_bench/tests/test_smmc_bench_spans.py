"""The program's spans in a trace (``smmc_bench/spans.py``): on a synthetic
Chrome trace that carries spans, launch calls and the device's own
``gpu_user_annotation`` ranges, and in whole traced runs on the CPU at a
tiny size. The harness's own readings (``trace.read``, the four
per-layer readers, ``breakdown``) read the same with the spans as
without them."""

import json

import pytest

from smmc_bench import cells, metrics, spans, trace
from smmc_bench.tests._tiny import CELLS, REPO, tiny_root


def _x(cat, name, s, e, corr=None):
    ev = dict(ph="X", cat=cat, name=name, ts=s, dur=e - s, args={})
    if corr is not None:
        ev["args"]["correlation"] = corr
    return ev


def _events(with_spans=True):
    """Window 0..1000 us, two bands queries at 100..450 and 500..950, a
    warm-up query's spans before the window; two kernels and a copy a
    query, each launched from inside a span, one kernel launched between
    the queries."""
    ev = [_x("user_annotation", trace.WINDOW_SPAN, 0.0, 1000.0),
          _x("cpu_op", "aten::copy_", 410.0, 420.0)]
    launch = 0
    for q0 in (100.0, 500.0):
        ev += [_x("kernel", "hist", q0 + 60, q0 + 250, launch + 1),
               _x("gpu_memcpy", "Memcpy DtoH", q0 + 250, q0 + 260,
                  launch + 2),
               _x("kernel", "edges", q0 + 20, q0 + 40, launch + 3),
               _x("cuda_runtime", "cudaLaunchKernel", q0 + 55, q0 + 58,
                  launch + 1),
               _x("cuda_runtime", "cudaMemcpyAsync", q0 + 58, q0 + 59,
                  launch + 2),
               _x("cuda_runtime", "cudaLaunchKernel", q0 + 15, q0 + 16,
                  launch + 3)]
        launch += 3
    ev += [_x("kernel", "fill", 470.0, 480.0, 99),
           _x("cuda_driver", "cuLaunchKernel", 460.0, 461.0, 99)]
    if with_spans:
        ev.append(_x("user_annotation", "smmc.simulate_bands", -80.0,
                     -10.0))
        for q0, q1 in ((100.0, 450.0), (500.0, 950.0)):
            ev += [_x("user_annotation", "smmc.simulate_bands", q0, q1),
                   _x("user_annotation", "smmc.prepare", q0, q0 + 50),
                   _x("user_annotation", "smmc.dispatch", q0 + 50,
                      q0 + 60),
                   _x("user_annotation", "smmc.wait", q0 + 60, q0 + 260),
                   _x("user_annotation", "smmc.merge", q0 + 260, q0 + 270),
                   _x("user_annotation", "smmc.invert", q0 + 270,
                      q0 + 300),
                   _x("user_annotation", "smmc.sample_paths", q0 + 300,
                      q0 + 320),
                   _x("gpu_user_annotation", "smmc.dispatch", q0 + 60,
                      q0 + 250)]
    return ev


class _Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _rec(events):
    rec = metrics.Records(setup_s=1.0, window_s=0.001,
                          walls_s=[0.00035, 0.00045], paths_per_query=1000,
                          least_s_per_query=50e-6)
    for key, value in trace.read(_Prof(events)).items():
        setattr(rec, key, value)
    return rec


def test_harness_readings_do_not_move_with_spans():
    plain, spanned = _rec(_events(False)), _rec(_events(True))
    # the device's gpu_user_annotation ranges stay out of device_ops
    assert spanned.device_ops == plain.device_ops
    assert {cat for _, cat, _, _ in spanned.device_ops} == {
        "kernel", "gpu_memcpy"}
    assert spanned.host_ops == plain.host_ops
    for name in ("device_idle_share", "host_gap_ms", "launches_per_query",
                 "roofline_share"):
        read = cells.load_module(REPO, "layer_metrics", name).read
        assert read(spanned) == read(plain) and read(plain) is not None
    assert trace.breakdown(spanned) == trace.breakdown(plain)


def test_collect_keeps_the_program_spans():
    found = spans.collect(_events())
    assert found["window"] == (0.0, 1000.0)
    names = [n for n, _, _ in found["spans"]]
    assert len(names) == 15 and set(names) == {
        "smmc.simulate_bands", "smmc.prepare", "smmc.dispatch",
        "smmc.wait", "smmc.merge", "smmc.invert", "smmc.sample_paths"}
    assert len(found["device"]) == 7
    assert found["calls"][99] == 460.0


def test_readings_on_a_synthetic_trace():
    found = spans.collect(_events())
    r = spans.readings(found, 2)
    # the warm-up query's spans lie before the window: left out
    assert r["entry_spans"] == 2
    assert r["entry_ms"] == pytest.approx((350 + 450) / 2 * 1e-3)
    assert r["host_wait_ms"] == pytest.approx(0.2)
    assert r["host_busy_ms"] == pytest.approx(0.4 - 0.2)
    assert r["prepare_ms"] == pytest.approx(0.05)
    assert r["dispatch_ms"] == pytest.approx(0.01)
    assert r["merge_ms"] == pytest.approx(0.01)
    assert r["invert_ms"] == pytest.approx(0.03)
    assert r["sample_paths_ms"] == pytest.approx(0.02)
    assert r["window_ms_per_query"] == pytest.approx(0.5)


def test_idle_and_launches_by_span():
    found = spans.collect(_events())
    r = spans.readings(found, 2)
    # a query's device ops cover q0+20..40 and q0+60..260; the fill
    # 470..480
    idle = r["idle_by_span"]
    us = 1e-6
    assert idle["smmc.prepare"] == pytest.approx(2 * (20 + 10) * us)
    assert idle["smmc.dispatch"] == pytest.approx(2 * 10 * us)
    assert idle["smmc.merge"] == pytest.approx(2 * 10 * us)
    assert idle["smmc.invert"] == pytest.approx(2 * 30 * us)
    assert idle["smmc.sample_paths"] == pytest.approx(2 * 20 * us)
    # q0+320 to the entry span's end: inside the entry, in no child
    assert idle["smmc.simulate_bands"] == pytest.approx((30 + 130) * us)
    assert r["idle_unnamed_s"] == idle["smmc.simulate_bands"]
    assert idle[spans.OUTSIDE] == pytest.approx(
        (100 + 20 + 20 + 50) * us)
    assert "smmc.wait" not in idle
    rec = _rec(_events())
    host_gap_ms = cells.load_module(REPO, "layer_metrics",
                                    "host_gap_ms").read(rec)
    assert r["idle_s"] == pytest.approx(host_gap_ms * 2 * 1e-3)
    launches = r["launches_by_span"]
    assert launches == {"smmc.prepare": 2, "smmc.dispatch": 4,
                        spans.OUTSIDE: 1}
    per_query = cells.load_module(REPO, "layer_metrics",
                                  "launches_per_query").read(rec)
    assert sum(launches.values()) == per_query * 2


def test_a_launch_with_no_call_is_named_so():
    events = [e for e in _events() if e["args"].get("correlation") != 99
              or e["cat"] == "kernel"]
    launches = spans.readings(spans.collect(events), 2)["launches_by_span"]
    assert launches[spans.NO_CALL] == 1 and spans.OUTSIDE not in launches


def test_nested_spans_name_the_innermost():
    nested = [("smmc.simulate_stats", 0.0, 100.0),
              ("smmc.prepare", 0.0, 10.0), ("smmc.wait", 10.0, 10.0),
              ("smmc.merge", 10.0, 40.0), ("smmc.simulate_stats", 40.0,
                                           40.0)]
    idle = spans.idle_by_span([(-5.0, 120.0)], nested)
    assert idle == pytest.approx({spans.OUTSIDE: 25e-6,
                                  "smmc.prepare": 10e-6,
                                  "smmc.merge": 30e-6,
                                  "smmc.simulate_stats": 60e-6})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_spans(root, cell):
    line = spans.run(root, cell, 2**31 + 9, 0.3, True, "cpu")
    assert line["correct"], line
    r = line["spans"]
    n = line["attempted"] - line["failed"]
    assert r["entry_spans"] == n >= 1
    bands = cells.find_cell(cells.load_manifest(root), cell)[
        "traffic"].startswith("bands")
    for key in ("host_wait_ms", "host_busy_ms", "prepare_ms",
                "dispatch_ms", "merge_ms"):
        assert r[key] > 0, key
    for key in ("invert_ms", "sample_paths_ms"):
        assert (r[key] > 0) == bands, key
    # no device on the CPU: the whole window is idle, named by span
    gap = line["metrics"]["host_gap_ms.bands" if bands else "host_gap_ms"]
    assert r["idle_s"] == pytest.approx(gap["value"] * n * 1e-3)
    assert r["launches_by_span"] == {}
    # the entry span within the query's wall
    assert r["entry_ms"] <= r["window_ms_per_query"]
    assert not spans.run(root, cell, 2**31 + 9, 0.3, False, "cpu").get(
        "spans")
