"""Registers, spills and SASS instructions of every kernel in two builds of
the port's CUDA sources, side by side: this checkout's and another
checkout's (for example a parent commit unpacked with ``git archive``),
each built with the same nvcc and flags (``ops/_build.NVCC_FLAGS``).

    python3 -m stock_market_monte_carlo_torch.bench.kernel_resources \\
        OTHER_ROOT [--rename OLD=NEW ...] [SOURCE ...]

SOURCE names files of ``csrc/`` (default: every source of
``ops/_build.SOURCES``); each is compiled to a cubin with ``-Xptxas -v``
in both trees where it exists, all in parallel. ``--rename OLD=NEW``
compares the other tree's kernels whose names hold OLD with this tree's
of the same name with NEW in its place (a kernel renamed between the
two). Prints one JSON line:
``{"kernels": {mangled name: {"this": [registers, spill stores, spill
loads, SASS instructions], "other": [...]}}, "differ": [names whose
numbers differ], "only_this": {name: [...]}, "only_other": {name:
[...]}}``; the names leave out the anonymous namespace nvcc names after
each source (its file and a hash), so that a kernel keeps its name when
its source is renamed. SASS
instructions are ``cuobjdump -sass``'s, NOPs left out. Needs the CUDA
toolkit, not a card. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from stock_market_monte_carlo_torch.ops import _build
from stock_market_monte_carlo_torch.ops import calibration as cal

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
# a name in the anonymous namespace nvcc names after a source (its path
# and file and a hash): _ZN<length><that namespace's name>...
_ANON = re.compile(r"_ZN(\d+)_GLOBAL__N_")


def _name(mangled: str) -> str:
    """A kernel's mangled name without its anonymous namespace, so that the
    same kernel of two checkouts (or of a renamed source) has one name."""
    m = _ANON.match(mangled)
    if not m:
        return mangled
    return "_ZN_GLOBAL__N_" + mangled[m.end(1) + int(m.group(1)):]


def ptxas_resources(report: str) -> dict:
    """{mangled name: (registers, spill stores, spill loads)} of a ptxas
    ``-v`` report."""
    out, name, spills = {}, None, (0, 0)
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            name, spills = _name(m.group(1)), (0, 0)
            continue
        m = _SPILLS.search(line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = _REGS.search(line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def build_resources(csrc: Path, sources, out_dir: Path) -> dict:
    """{mangled name: [registers, spill stores, spill loads, SASS
    instructions]} of every kernel of ``sources`` in ``csrc``."""
    nvcc = _build._find_nvcc()
    cubins = [out_dir / f"{Path(src).stem}.cubin" for src in sources]
    cmds = [[nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o",
             str(cubin), str(csrc / src)]
            for src, cubin in zip(sources, cubins)]
    resources = ptxas_resources(_build._run_all(cmds))
    tool = Path(nvcc).with_name("cuobjdump")
    out = {}
    for cubin in cubins:
        listing = subprocess.run([str(tool), "-sass", str(cubin)],
                                 capture_output=True, text=True, timeout=300,
                                 check=True).stdout
        for body in listing.split("Function : ")[1:]:
            name = _name(body.split("\n", 1)[0].strip())
            out[name] = [*resources[name],
                         len(cal._instructions(body)[0])]
    return out


def compare(other_root: Path, sources=None, renames=()) -> dict:
    this_csrc = _build.CSRC_DIR
    other_csrc = other_root / this_csrc.relative_to(this_csrc.parents[1])
    sources = [s for s in (sources or _build.SOURCES)
               if (this_csrc / s).exists() or (other_csrc / s).exists()]
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        this_dir, other_dir = Path(tmp, "this"), Path(tmp, "other")
        this_dir.mkdir()
        other_dir.mkdir()
        this = build_resources(
            this_csrc, [s for s in sources if (this_csrc / s).exists()],
            this_dir)
        other = build_resources(
            other_csrc, [s for s in sources if (other_csrc / s).exists()],
            other_dir)
    for old, new in renames:
        other = {k.replace(old, new): v for k, v in other.items()}
    both = sorted(set(this) & set(other))
    return dict(
        kernels={k: {"this": this[k], "other": other[k]} for k in both},
        differ=[k for k in both if this[k] != other[k]],
        only_this={k: this[k] for k in sorted(set(this) - set(other))},
        only_other={k: other[k] for k in sorted(set(other) - set(this))})


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    renames = []
    while "--rename" in argv:
        i = argv.index("--rename")
        renames.append(tuple(argv[i + 1].split("=", 1)))
        del argv[i:i + 2]
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    print(json.dumps(compare(Path(argv[0]).resolve(), argv[1:] or None,
                             renames)))


if __name__ == "__main__":
    main()
