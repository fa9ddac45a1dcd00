"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources under ``csrc/`` compile into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds). Each source
compiles in its own nvcc process, all started together, then one nvcc
links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu   (each source)
    nvcc -shared -o build/torch_kernels/libsmmc_cuda_<hash>.so *.o

``-fmad=false`` keeps nvcc from contracting a*b+c into an fma, which
would round differently from the JAX package and the plain versions (the
withdrawn total, the centred moments, the Clenshaw step, the band bins).
The library is built at first use into ``build/torch_kernels`` at the
repository root (resolved from this file, not from the working directory)
and named by a hash of the sources and flags, so an edited source is
rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
SOURCES = ("month_loop.cu", "run_loop.cu", "threefry_loop.cu",
           "terminal_law.cu", "clt.cu", "bands.cu", "calibration.cu",
           "histogram.cu", "byte_planes.cu")
HEADERS = ("smmc_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_vp = ctypes.c_void_p
_i = ctypes.c_int
_u = ctypes.c_uint
_f = ctypes.c_float
_ARGTYPES = {
    "smmc_month_loop": (_i, _vp, _i, _i, _i, _f, _f, _vp, _vp, _i, _u, _u,
                        _vp, _i, _f, _i, _u, _u, _i, _f, _f, _f, _f, _f,
                        _f, _i, _vp, _vp, _vp, _i, _vp),
    "smmc_run_info": (_i, _i, _i, _i, _i, _i, _i, _vp),
    "smmc_run_loop": (_i, _vp, _i, _i, _i, _f, _f, _vp, _vp, _i, _u, _u,
                      _vp, _i, _f, _i, _u, _u, _i, _f, _f, _f, _f, _f,
                      _f, _i, _vp, _vp, _vp, _i, _vp),
    "smmc_threefry_loop": (_i, _vp, _i, _u, _f, _f, _vp, _i, _f, _i, _u,
                           _u, _u, _i, _f, _f, _f, _f, _f, _f, _i, _vp, _vp,
                           _vp, _i, _vp),
    "smmc_law": (_vp, _i, _u, _u, _i, _f, _f, _f, _f, _f, _f, _i,
                 _vp, _vp, _vp, _vp, _vp, _vp, _i, _u, _u, _i, _vp),
    "smmc_clt": (_i, _vp, _vp, _vp, _vp, _i, _i, _u, _u, _i, _f, _f, _f,
                 _f, _f, _f, _i, _vp, _vp, _vp, _i, _vp),
    "smmc_clt_probe": (_i, _i, _vp, _vp, _vp, _i, _i, _u, _u, _i, _f, _f,
                       _f, _f, _f, _f, _i, _vp, _vp, _vp, _i, _vp),
    "smmc_bands": (_i, _i, _vp, _i, _i, _i, _f, _f, _vp, _vp, _vp, _vp, _vp,
                   _i, _u, _u, _i, _f, _i, _vp, _vp),
    "smmc_bands_info": (_i, _i, _i, _i, _i, _i, _i, _vp),
    "smmc_counts_below_tile": (_vp, _vp, _i, _vp, _vp),
    "smmc_grid_overhead": (_i, _u, _u, _i, _i, _vp, _vp, _vp),
    "smmc_calib": (_i, _u, _i, _i, _vp, _vp),
    "smmc_op_toy": (_i, _f, _f, _i, _i, _vp, _i, _vp, _vp),
    "smmc_byte_planes": (_vp, _i, _vp, _vp),
    "smmc_histogram": (_i, _vp, _i, _i, _f, _f, _f, _vp, _vp),
    "smmc_flatten_tile": (_vp, _vp, _i, _vp),
}

_LIB = None


def _find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libsmmc_cuda_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails; return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the library unless it is already built; return its path.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    extra = ["-Xptxas", "-v"] if verbose else []
    try:
        report = _run_all([
            [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj),
             str(CSRC_DIR / src)] for src, obj in zip(SOURCES, objs)])
        tmp = out.with_name(f"{tag}.tmp.so")
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if verbose:
        print(report, end="")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The built library with argtypes/restype declared (built on first
    call, then cached for the process)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
