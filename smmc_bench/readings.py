"""The readings that a cell's limits are set from, at the cell's own size:

    python3 -m smmc_bench.readings --workload <cell> --first-seed <n> \
        --seeds 12 --control 3 [--out <file.json>]

For each of ``--seeds`` run seeds (``first-seed``, ``first-seed`` + 1,
...) one query of the program, as the window calls it, and the plain
reference's answer to it; the compared numbers of each. For the first
``--control`` of them also the control: the reference in the program's
place computed in bfloat16, the precision below the float32 that the
configurations state, against the float32 reference. Prints a line per
seed and, last, the largest number the program read (the lower reading)
and the least the control read (the upper), by name.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from smmc_bench import cells, check
from smmc_bench.run import ROOT, query_seed


def readings(root, workload, first_seed, n_seeds, n_control, device):
    import torch

    from smmc_bench import reference
    from smmc_bench.program import Program

    cell = cells.find_cell(cells.load_manifest(root), workload)
    cfg = cells.config(root, cell["config"])
    mix = cells.traffic(root, cell["traffic"])
    table = (cells.read_table(root, cfg)
             if "table" in cfg["model"] else None)
    program = Program(cfg, mix, table, device)
    dev = torch.device(device)
    n = int(cfg["n_paths"])
    cdf = mix["call"].get("band_mode") == "cdf"
    rows = []
    for k in range(n_seeds):
        seed = first_seed + k
        s = query_seed(seed, 0)
        answer = program.answer(program(s))
        t = time.perf_counter()
        ref = reference.query(cfg, mix, table, s, dev)
        row = dict(seed=seed, reference_s=time.perf_counter() - t,
                   program=check.gaps(mix["check"], answer, ref, n, cdf))
        if k < n_control:
            ctl = reference.query(cfg, mix, table, s, dev, torch.bfloat16)
            row["control"] = check.gaps(mix["check"], ctl, ref, n, cdf)
        print(json.dumps(row), flush=True)
        rows.append(row)
    names = rows[0]["program"].keys()
    summary = dict(
        workload=workload,
        lower={m: max(r["program"][m] for r in rows) for m in names},
        upper={m: min(r["control"][m] for r in rows if "control" in r)
               for m in names} if n_control else {},
        seeds=[r["seed"] for r in rows], rows=rows)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    summary = readings(ROOT, args.workload, args.first_seed, args.seeds,
                       args.control, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in ("workload", "lower",
                                                "upper")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
