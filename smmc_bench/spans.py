"""The program's own spans in a traced run, and what they read.

The port records ``smmc.*`` spans inside its two entry points
(``stock_market_monte_carlo_torch.utils.timing``): ``torch.profiler``
ranges, so they land in the same Chrome trace as the device's operations,
as ``user_annotation`` events on the profiler's clock. This module reads
them from that trace, beside what ``trace.read`` reads:

- the spans, ``(name, start, end)``;
- each device operation's launch call (the ``cuda_runtime`` or
  ``cuda_driver`` event with the operation's ``correlation`` id).

and gives, over the traced window and per completed query:

- ``host_wait_ms``: ``smmc.wait``, the host blocked on the card;
- ``host_busy_ms``: the entry spans (``smmc.simulate_stats``,
  ``smmc.simulate_bands``) less their ``smmc.wait``: the host's own work;
- ``prepare_ms``, ``dispatch_ms``, ``merge_ms``, ``invert_ms``,
  ``sample_paths_ms``: the other spans;
- ``idle_by_span``: every idle gap of the device in the window, cut at the
  span boundaries and each part named by the innermost span open over it
  ("outside the program" where none is), in seconds. Its sum is the
  window less its device-busy union, which ``host_gap_ms`` reads;
- ``launches_by_span``: the window's device operations, each counted
  under the innermost span open at its launch call's start. Its sum is
  what ``launches_per_query`` counts.

The harness's readers cannot see the spans yet: ``trace.read`` keeps the
window's ``user_annotation`` and no launch call, and ``metrics.Records``
has no field for either. Until it does, ``run`` and ``main`` run a cell
as ``run.run_cell`` runs it (by wrapping ``trace.read``) and print these
readings beside the harness's line. They are scaffolding: the benchmark
change that has ``trace.read`` call ``collect`` (its one parse of the
trace) and ``breakdown`` report ``idle_by_span`` and
``launches_by_span`` deletes them, with ``_events`` and ``_Exported``::

    python3 -m smmc_bench.spans --workload <cell> --seed <n> \\
        --seconds <s> --traces 0,1,1,0 [--out <file.jsonl>] \\
        [--keep-traces <dir>]

one run a flag of ``--traces`` (1: traced), in one process, in turns, run
k under ``--seed`` + k.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import sys
import tempfile
from collections import defaultdict

from smmc_bench import metrics
from smmc_bench import trace as tracing

PREFIX = "smmc."
ENTRIES = ("smmc.simulate_stats", "smmc.simulate_bands")
WAIT = "smmc.wait"
OUTSIDE = "outside the program"
NO_CALL = "no launch call in the trace"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the per-query readings: (key, spans summed); host_busy_ms subtracts wait
READINGS = (("host_wait_ms", (WAIT,)),
            ("prepare_ms", ("smmc.prepare",)),
            ("dispatch_ms", ("smmc.dispatch",)),
            ("merge_ms", ("smmc.merge",)),
            ("invert_ms", ("smmc.invert",)),
            ("sample_paths_ms", ("smmc.sample_paths",)),
            ("entry_ms", ENTRIES))


def collect(events) -> dict:
    """The window, the program's spans, the device operations with their
    correlation ids and the launch calls' starts by correlation id, of a
    Chrome trace's events."""
    window, spans, device, calls = None, [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        corr = ev.get("args", {}).get("correlation")
        if cat == "user_annotation":
            if name == tracing.WINDOW_SPAN:
                window = (s, e)
            elif name.startswith(PREFIX):
                spans.append((name, s, e))
        elif cat in tracing.DEVICE_CATEGORIES:
            device.append((name, cat, s, e, corr))
        elif cat in LAUNCH_CATEGORIES and corr is not None:
            calls[corr] = s
    spans.sort(key=lambda sp: (sp[1], -sp[2]))
    return dict(window=window, spans=spans, device=device, calls=calls)


def _segments(spans):
    """(bounds, labels): time cut at every span boundary; ``labels[i]``
    names the innermost span open over [bounds[i], bounds[i + 1]), None
    where none is (also before the first bound and after the last)."""
    marks = []
    for i, (_, s, e) in enumerate(spans):
        if e <= s:
            continue  # holds no time
        # at one instant: closes before opens, and of spans opening
        # together the outer first (a close finds its span by index)
        marks.append((s, 1, s - e, i))
        marks.append((e, 0, s - e, i))
    marks.sort()
    bounds, labels, open_ = [], [], []
    for t, opens, _, i in marks:
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
        bounds.append(t)
        labels.append(spans[open_[-1]][0] if open_ else None)
    return bounds, labels


def _label_at(bounds, labels, t):
    j = bisect.bisect_right(bounds, t) - 1
    return labels[j] if j >= 0 else None


def idle_by_span(gaps, spans) -> dict:
    """Seconds of the (start, end) ``gaps`` (microseconds) by the innermost
    span open over each part of them."""
    bounds, labels = _segments(spans)
    out = defaultdict(float)
    for gs, ge in gaps:
        at, j = gs, bisect.bisect_right(bounds, gs) - 1
        while at < ge:
            end = min(ge, bounds[j + 1]) if j + 1 < len(bounds) else ge
            out[(labels[j] if j >= 0 else None) or OUTSIDE] += \
                (end - at) * 1e-6
            at, j = end, j + 1
    return dict(out)


def launches_by_span(device, calls, spans, lo, hi) -> dict:
    """The device operations inside [lo, hi] (as ``launches_per_query``
    counts them), counted by the innermost span open at the start of their
    launch call."""
    bounds, labels = _segments(spans)
    out = defaultdict(int)
    for _, _, s, e, corr in device:
        if s >= lo and e <= hi:
            t = calls.get(corr)
            label = (NO_CALL if t is None
                     else _label_at(bounds, labels, t) or OUTSIDE)
            out[label] += 1
    return dict(out)


def readings(found: dict, n_queries: int) -> dict:
    """The module docstring's readings of ``collect``'s output over its
    window, per query where it says so."""
    lo, hi = found["window"]
    spans = [sp for sp in found["spans"] if sp[1] >= lo and sp[2] <= hi]
    total = defaultdict(float)
    for name, s, e in spans:
        total[name] += e - s
    out = {key: sum(total[n] for n in names) * 1e-3 / n_queries
           for key, names in READINGS}
    out["host_busy_ms"] = out["entry_ms"] - out["host_wait_ms"]
    ops = [(s, e) for _, _, s, e, _ in found["device"]]
    gaps = metrics.idle_gaps(ops, lo, hi)
    idle = idle_by_span(gaps, spans)
    out["idle_by_span"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
    out["idle_s"] = sum(idle.values())
    # idle inside an entry span that no child span holds
    out["idle_unnamed_s"] = sum(idle.get(n, 0.0) for n in ENTRIES)
    out["launches_by_span"] = launches_by_span(
        found["device"], found["calls"], spans, lo, hi)
    out["window_s"] = (hi - lo) * 1e-6
    # the mean query wall, and the harness's loop between queries
    out["window_ms_per_query"] = (hi - lo) * 1e-3 / n_queries
    out["entry_spans"] = sum(1 for n, _, _ in spans if n in ENTRIES)
    return out


def _events(prof, path):
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


class _Exported:
    """A finished profile's Chrome trace already written to ``path``, for
    ``trace.read``, which exports it again."""

    def __init__(self, path):
        self.path = path

    def export_chrome_trace(self, path):
        shutil.copyfile(self.path, path)


def run(root, workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", keep: str = None) -> dict:
    """One run of ``workload`` as ``run.run_cell`` runs it: its result
    line, and under ``spans`` the readings of a traced run, whose Chrome
    trace is copied to ``keep`` where given."""
    from smmc_bench import run as harness

    found = {}
    read = tracing.read

    def read_and_keep(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            found.update(collect(_events(prof, path)))
            if keep:
                shutil.copyfile(path, keep)
            return read(_Exported(path))
        finally:
            os.unlink(path)

    tracing.read = read_and_keep
    try:
        line = harness.run_cell(root, workload, seed, seconds, traced,
                                device)
    finally:
        tracing.read = read
    if traced:
        n = line["attempted"] - line["failed"]
        line["spans"] = readings(found, n) if n else None
    return line


def main(argv=None) -> int:
    from smmc_bench.run import ROOT

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--traces", default="0,1",
                    help="one run a flag, in order (1: traced)")
    ap.add_argument("--out", help="also append each line to this file")
    ap.add_argument("--keep-traces", metavar="DIR",
                    help="keep each traced run's Chrome trace in DIR")
    args = ap.parse_args(argv)
    for k, flag in enumerate(args.traces.split(",")):
        seed, traced = args.seed + k, flag.strip() == "1"
        keep = None
        if traced and args.keep_traces:
            os.makedirs(args.keep_traces, exist_ok=True)
            keep = os.path.join(args.keep_traces,
                                f"{args.workload}.{seed}.json")
        line = run(ROOT, args.workload, seed, args.seconds, traced,
                   keep=keep)
        line.update(workload=args.workload, seed=seed, traced=traced)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
