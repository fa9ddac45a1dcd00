"""Run one cell of the port's benchmark once and print its result line.

    python3 -m smmc_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. One process runs one cell once:

1. set-up (``setup_s``): torch and the port imported, the CUDA context,
   the kernel library loaded from ``build/torch_kernels/`` (built there by
   a checkout's first run), the cell's table read, and one warm-up query
   at the cell's shapes;
2. the window: one client in a closed loop for ``--seconds``. Query i
   calls the cell's entry point with the seed of ``query_seed(seed, i)``
   and is timed from the call until its result is on the host after a
   ``torch.cuda.synchronize()``. The window closes when the last query
   begun inside it has its result. With ``--trace 1`` the profiler
   records the window;
3. the check: one query that the window completed, drawn from the seed,
   is computed again by the plain reference (``reference/``) and compared
   (``check.py``); then the result line, the compared numbers last on
   standard error and under ``checks`` in the line.

Exits non-zero without a line where torch finds fewer CUDA devices than
the cell asks for, or where jax, jaxlib, flax or the JAX package was
loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from smmc_bench import cells, check, metrics  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stock_market_monte_carlo_tpu")
# SeedSequence words past every query index: the warm-up's and the
# sample's
_WARMUP, _SAMPLE = 1 << 32, (1 << 32) + 1


def query_seed(seed: int, i: int) -> int:
    """The seed of query ``i`` of a run under ``seed``: the first uint32
    word of numpy's SeedSequence([seed, i])."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(i)])
    return int(ss.generate_state(1, np.uint32)[0])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one that must not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def query_work(root: Path, config: dict, traffic: dict) -> dict:
    """One query's work: the configuration's draw and the mix's
    algorithms (``work/<name>.py``), summed."""
    total = dict(bytes=0.0, scalar_ops=0.0, tensor_flop=0.0)
    for name in [config["work"], *traffic["work"]]:
        part = cells.load_module(root, "work", name).work(config, traffic)
        for key in total:
            total[key] += float(part[key])
    return total


def _power_limit():
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: float = None) -> dict:
    """One run of ``workload``: set-up, the window, the check. Returns the
    result line as a dict (its ``checks`` last)."""
    import torch

    from smmc_bench import reference
    from smmc_bench import trace as tracing
    from smmc_bench.program import Program

    t0 = time.perf_counter() if t0 is None else t0
    manifest = cells.load_manifest(root)
    cell = cells.find_cell(manifest, workload)
    cfg = cells.config(root, cell["config"])
    mix = cells.traffic(root, cell["traffic"])
    limits = cells.limits(root, workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    table = (cells.read_table(root, cfg)
             if "table" in cfg["model"] else None)
    program = Program(cfg, mix, table, device)
    program(query_seed(seed, _WARMUP))
    sync()
    setup_s = time.perf_counter() - t0

    sampler = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), _SAMPLE]))
    walls, errors, kept = [], [], None
    with tracing.profiled(trace, dev.type) as (prof, span):
        with span():
            start = end = time.perf_counter()
            deadline = start + seconds
            i = 0
            while end < deadline:
                s = query_seed(seed, i)
                called = time.perf_counter()
                try:
                    res = program(s)
                    sync()
                except Exception as exc:  # counted, and fails the run
                    errors.append(f"query {i}: {exc!r}")
                    res = None
                end = time.perf_counter()
                if res is not None:
                    walls.append(end - called)
                    # a uniform sample of one completed query (reservoir)
                    if sampler.random() * len(walls) < 1.0:
                        kept = (i, s, res)
                i += 1
    window_s = end - start
    attempted = i
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    n_paths = int(cfg["n_paths"])
    rec = metrics.Records(
        setup_s=setup_s, window_s=window_s, walls_s=walls,
        paths_per_query=n_paths,
        least_s_per_query=metrics.least_seconds(query_work(root, cfg, mix)))
    if trace:
        for key, value in tracing.read(prof).items():
            setattr(rec, key, value)
    section = "per_layer" if trace else "end_to_end"
    out = {}
    for m in cells.cell_metrics(manifest, workload, section):
        value = cells.load_module(
            root, "layer_metrics" if trace else "end_to_end",
            m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the check, once the window has closed and the program's state is
    # freed: the sampled query again by the reference, on the same device
    numbers, ref_s = {}, None
    if kept is not None:
        q_index, q_seed, res = kept
        answer = program.answer(res)
        del res, kept, program
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref = reference.query(cfg, mix, table, q_seed, dev)
        ref_s = time.perf_counter() - t_ref
        numbers = check.gaps(mix["check"], answer, ref, n_paths,
                             mix["call"].get("band_mode") == "cdf")
    ok, rows = check.judge(numbers, limits)
    line = {
        "correct": bool(ok and not errors and attempted > 0),
        "attempted": attempted,
        "failed": len(errors),
        "metrics": out,
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": int(cell["chips"]),
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        window, busy = metrics.device_window(rec)
        line["device"].update(busy_s=busy, window_s=window)
        if cuda:
            line["device"]["name_power_limit"] = _power_limit()
        line["breakdown"] = tracing.breakdown(rec)
    line["errors"] = errors[:5]
    line["checked_query"] = None if not numbers else q_index
    line["reference_s"] = ref_s
    if walls:
        line["query_ms"] = {q: metrics.quantile(walls, v) * 1e3 for q, v in
                            (("min", 0.0), ("median", 0.5), ("max", 1.0))}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in rows}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = cells.find_cell(cells.load_manifest(ROOT), args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"smmc_bench: {exc}", file=sys.stderr)
        return 2
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"smmc_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch finds {found}", file=sys.stderr)
        return 3
    try:
        line = run_cell(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", _T0)
    except ImportError as exc:
        print(f"smmc_bench: the port does not import: {exc!r}",
              file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"smmc_bench: loaded {', '.join(found)}; the benchmark runs "
              "the port alone", file=sys.stderr)
        return 5
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
