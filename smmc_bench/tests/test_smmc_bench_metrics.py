"""The metric arithmetic on synthetic records: the rate, the tail, the
union of device intervals, the idle share, the host gap, the launches and
the roofline share, and the trace's breakdown."""

import pytest

from smmc_bench import cells, metrics, trace
from smmc_bench.tests._tiny import REPO


def _rec(**kw):
    base = dict(setup_s=12.5, window_s=2.0, walls_s=[0.1] * 9 + [0.3],
                paths_per_query=1000, least_s_per_query=0.05)
    base.update(kw)
    return metrics.Records(**base)


def _read(folder, name, rec):
    return cells.load_module(REPO, folder, name).read(rec)


def test_rate_tail_setup():
    rec = _rec()
    assert _read("end_to_end", "paths_per_s", rec) == pytest.approx(5000.0)
    # ten walls: the 90th percentile lies 0.9 of the way from the 9th
    # (0.1) to the 10th (0.3)
    assert _read("end_to_end", "query_p90_ms", rec) == pytest.approx(120.0)
    assert _read("end_to_end", "setup_s", rec) == 12.5
    assert _read("end_to_end", "paths_per_s", _rec(walls_s=[])) is None


@pytest.mark.parametrize("intervals,lo,hi,want", [
    ([], 0.0, 10.0, 0.0),
    ([(1, 3), (2, 5), (7, 8)], 0.0, 10.0, 5.0),
    ([(1, 3), (3, 4)], 0.0, 10.0, 3.0),
    ([(-5, 2), (9, 20)], 0.0, 10.0, 3.0),
    ([(0, 10), (2, 3)], 0.0, 10.0, 10.0),
    ([(4, 6), (1, 2)], 3.0, 5.0, 1.0),
])
def test_union(intervals, lo, hi, want):
    assert metrics.union_us(intervals, lo, hi) == pytest.approx(want)


def test_idle_gaps():
    assert metrics.idle_gaps([(1, 3), (2, 5), (7, 8)], 0.0, 10.0) == [
        (0.0, 1), (5, 7), (8, 10.0)]


def _traced():
    # window 0..1000 us, two queries; device busy 100..400 and 500..700
    # (a kernel overlapping a copy), one memset; host ops around
    ops = [("k1", "kernel", 100.0, 300.0), ("cp", "gpu_memcpy", 250.0, 400.0),
           ("k1", "kernel", 500.0, 650.0), ("ms", "gpu_memset", 650.0, 700.0)]
    host = [("aten::sum", 0.0, 90.0), ("aten::copy_", 400.0, 480.0)]
    return _rec(window_s=0.001, walls_s=[0.0005, 0.0005],
                least_s_per_query=70e-6, trace_window_us=(0.0, 1000.0),
                device_ops=ops, host_ops=host)


def test_layer_metrics():
    rec = _traced()
    # busy: 100..400 and 500..700 = 500 us of 1000
    assert _read("layer_metrics", "device_idle_share", rec) == \
        pytest.approx(0.5)
    assert _read("layer_metrics", "host_gap_ms", rec) == pytest.approx(0.25)
    assert _read("layer_metrics", "launches_per_query", rec) == 2.0
    # kernels 350 us; least time 2 x 70 us
    assert _read("layer_metrics", "roofline_share", rec) == \
        pytest.approx(100.0 * 140.0 / 350.0)
    for name in ("device_idle_share", "host_gap_ms", "launches_per_query",
                 "roofline_share"):
        assert _read("layer_metrics", name, _rec()) is None


def test_breakdown():
    b = trace.breakdown(_traced())
    assert b["device_ops"][0] == ["k1", pytest.approx(350e-6)]
    # gaps 0..100, 400..500 and 700..1000, each named by the host
    # operation running at its middle, longest first
    assert b["idle_gaps"] == [["host: no torch operation", pytest.approx(
        300e-6)], ["host: aten::sum", pytest.approx(100e-6)],
        ["host: aten::copy_", pytest.approx(100e-6)]]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_least_seconds_at_published_peaks():
    w = dict(bytes=3.35e12, scalar_ops=0.0, tensor_flop=0.0)
    assert metrics.least_seconds(w) == pytest.approx(1.0)
    w = dict(bytes=0.0, scalar_ops=2 * 132 * 128 * 1.98e9, tensor_flop=0.0)
    assert metrics.least_seconds(w) == pytest.approx(2.0)
