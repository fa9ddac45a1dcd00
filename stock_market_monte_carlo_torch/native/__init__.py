"""ctypes binding to the C++ runtime library (``csrc/smmc_native.cpp``).

Counterpart of ``stock_market_monte_carlo_tpu/native/__init__.py``, for the
same shared source: a CSV reader, the data-file writer, the Sobol
generators and the Welford merge of the reference's C++ runtime. It is
host code and touches no device. The library loads from
``$SMMC_NATIVE_LIB`` first, else from ``build/torch_kernels/
libsmmc_native.so`` at the repository root (``ops/_build.BUILD_DIR``),
which ``build()`` compiles:

    g++ -O3 -std=c++20 -fPIC -shared -o build/torch_kernels/libsmmc_native.so
        csrc/smmc_native.cpp

(``make native`` builds it too). Without a library every entry point
falls back as the JAX binding's do: the reader and the Sobol generators
return None, the writer False (callers then use Python), and the Welford
merge raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from stock_market_monte_carlo_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "smmc_native.cpp"
LIBRARY = BUILD_DIR / "libsmmc_native.so"
CXX_FLAGS = ("-O3", "-std=c++20", "-fPIC", "-shared")

_LIB = None
_LOAD_ATTEMPTED = False


def build(out: Optional[Path] = None) -> Path:
    """Compile ``csrc/smmc_native.cpp`` into ``out`` (default ``LIBRARY``)
    with ``$CXX`` (default g++) ``-O3 -std=c++20 -fPIC -shared``; return
    its path. The next call of a native entry point loads it."""
    global _LOAD_ATTEMPTED
    out = Path(out) if out is not None else LIBRARY
    cxx = os.environ.get("CXX") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    if _LIB is None:
        _LOAD_ATTEMPTED = False
    return out


def _lib():
    global _LIB, _LOAD_ATTEMPTED
    if _LOAD_ATTEMPTED:
        return _LIB
    _LOAD_ATTEMPTED = True
    for path in (os.environ.get("SMMC_NATIVE_LIB", ""), str(LIBRARY)):
        if path and os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                _configure(lib)
            except (OSError, AttributeError):
                # AttributeError: a stale library without a newer symbol
                continue
            _LIB = lib
            break
    return _LIB


def _configure(lib):
    lib.smmc_read_returns.restype = ctypes.c_long
    lib.smmc_read_returns.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.smmc_write_data_file.restype = ctypes.c_int
    lib.smmc_write_data_file.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.smmc_sobol_points.restype = ctypes.c_int
    lib.smmc_sobol_points.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,   # direction, dims
        ctypes.c_longlong, ctypes.c_longlong,            # offset, n
        ctypes.POINTER(ctypes.c_double)]                 # out (n*dims)
    lib.smmc_sobol_bits64.restype = ctypes.c_int
    lib.smmc_sobol_bits64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,   # direction64, dims
        ctypes.c_longlong, ctypes.c_longlong,            # offset, n
        ctypes.POINTER(ctypes.c_uint64)]                 # out (n*dims)
    lib.smmc_welford_merge.restype = None
    lib.smmc_welford_merge.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]


def available() -> bool:
    return _lib() is not None


def native_read_returns(path: str) -> Optional[np.ndarray]:
    """The ``returns`` column through the C++ CSV reader; None without the
    library, or where the reader's cap may have cut the table (callers
    then read in Python)."""
    lib = _lib()
    if lib is None:
        return None
    cap = 1 << 22
    buf = np.empty(cap, np.float32)
    n = lib.smmc_read_returns(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap)
    if n < 0:
        raise IOError(f"native CSV reader failed on {path!r} (code {n})")
    if n >= cap:
        return None
    return buf[:n].copy()


def native_write_data_file(path: str, returns: np.ndarray,
                           values: np.ndarray) -> bool:
    """Write a ``Returns,,/Values,`` CSV in C++; False without the
    library."""
    lib = _lib()
    if lib is None:
        return False
    r = np.ascontiguousarray(returns, np.float32)
    v = np.ascontiguousarray(values, np.float32)
    rc = lib.smmc_write_data_file(
        path.encode(),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), r.size,
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.size)
    return rc == 0


def native_welford_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Merge [n, mean, M2] partition stats ``b`` into ``a`` (Chan et al.,
    exact); returns the merged row, the C++ cross-check of
    ``ops.reductions.welford_combine``."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(
            "native library not built (native.build() or `make native`)")
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    lib.smmc_welford_merge(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return a


def native_sobol_points(direction: np.ndarray, offset: int,
                        n: int) -> Optional[np.ndarray]:
    """Unscrambled Sobol points (n, dims) in [0, 1), float64, by the C++
    Gray-code recurrence; None without the library."""
    lib = _lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(direction, np.uint32)
    dims = d.shape[0]
    out = np.empty((n, dims), np.float64)
    rc = lib.smmc_sobol_points(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), dims, offset, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"native sobol failed (code {rc})")
    return out


def native_sobol_bits64(direction64: np.ndarray, offset: int,
                        n: int) -> Optional[np.ndarray]:
    """Raw 64-bit Sobol fold states (n, dims) for positions past 2^32; None
    without the library."""
    lib = _lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(direction64, np.uint64)
    dims = d.shape[0]
    out = np.empty((n, dims), np.uint64)
    rc = lib.smmc_sobol_bits64(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), dims, offset, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if rc != 0:
        raise RuntimeError(f"native sobol64 failed (code {rc})")
    return out
