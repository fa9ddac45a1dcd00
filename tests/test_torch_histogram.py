"""The histogram kernel's plain versions and the tile flatten against the
histogram probes of ``experiments/`` and the JAX package's histogram
binning, on the CPU.

``experiments/exp_pallas_hist.py``, ``exp_rowhist.py`` and
``exp_flatten_cost.py`` assert a TPU backend and measure when imported,
so they are not loaded as modules: each kernel function, the module
constants it reads and the file's own ``pl.pallas_call`` statement are
compiled out of the file's syntax tree, with the grid cut to a few tiles
and ``pl.pallas_call`` in interpret mode (through ``monkeypatch``). The
inputs come from numpy seeds (the experiments draw theirs from
``jax.random.key(0)``; numpy's seed 0 stands in for it). Neither the JAX
package nor ``experiments/`` is touched.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_torch.bench import probes, roofline
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_torch.ops import histogram
from stock_market_monte_carlo_tpu.ops.reductions import HistogramSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HB = 4096


def _experiment(name, small, defs, extra=None, consts=None):
    """Namespace of ``experiments/<name>.py`` with its upper-case module
    constants (only those named in ``consts``, if given; each name in
    ``small`` replaced right after its own assignment, so the constants
    derived from it follow) and the top-level or nested statements that
    define the names in ``defs``; ``extra`` holds the names the file
    imports or builds otherwise."""
    with open(os.path.join(REPO, "experiments", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    ns = dict(jax=jax, jnp=jnp, np=np, pl=pl, pltpu=pltpu, **(extra or {}))

    def run(node):
        exec(compile(ast.Module([node], type_ignores=[]), name, "exec"), ns)

    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = [n.id for t in node.targets
                     for n in ast.walk(t) if isinstance(n, ast.Name)]
            if names and all(n.isupper() and (consts is None
                                              or n in consts)
                             for n in names):
                run(node)
                ns.update({n: small[n] for n in names if n in small})
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in defs:
            run(node)
        elif (isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Name)
              and node.targets[0].id in defs):
            run(node)
    return ns


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _indices(n, seed=0):
    """int32 indices in [0, HB], a few at HB (a masked lane's index)."""
    idx = np.random.default_rng(seed).integers(0, HB, n).astype(np.int32)
    idx[::97] = HB
    return idx


def _port_counts(x, hb=HB, mode="index"):
    return histogram.histogram_counts(torch.as_tensor(x), hb,
                                      mode=mode).numpy()


def _bincount(bins, hb=HB):
    bins = np.asarray(bins).ravel()
    return np.bincount(bins[(bins >= 0) & (bins < hb)], minlength=hb)


# ---------------------------------------------------------------------------
# The experiments' kernels
# ---------------------------------------------------------------------------


def test_index_mode_matches_exp_pallas_hist(interpret):
    """(4096,1) column tiles, 3 of them: the experiment's jitted
    ``hist_pallas`` (its pallas_call, its tile sum)."""
    ns = _experiment("exp_pallas_hist", dict(B=3 * 4096),
                     ("hist_kernel", "call", "hist_pallas"))
    idx = _indices(3 * 4096)
    want = np.asarray(ns["hist_pallas"](jnp.asarray(idx)), np.int64)
    got = _port_counts(idx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _bincount(idx))


def test_index_mode_matches_exp_rowhist(interpret):
    """(64,128) row tiles with 64 NT gemms a tile, 2 tiles."""
    ns = _experiment("exp_rowhist", dict(B=2 * 8192),
                     ("hist_kernel", "call", "hist_pallas"))
    idx = _indices(2 * 8192, seed=1)
    want = np.asarray(ns["hist_pallas"](jnp.asarray(idx)), np.int64)
    got = _port_counts(idx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _bincount(idx))


def test_clip_cast_mode_matches_exp_flatten_cost_k_hist(interpret):
    """The float input cast to int32, clipped to [0, 4095], flattened and
    counted in the kernel; 2 tiles, with values outside [0, 4096) and a
    NaN (XLA's cast saturates and sends NaN to 0, as the card's does)."""
    ns = _experiment("exp_flatten_cost", dict(NT=2), ("k_hist", "call"))
    x = (np.random.default_rng(0).uniform(0.0, 1.0, (2 * 64, 128))
         .astype(np.float32) * np.float32(4096.0))
    x[0, :6] = (-3.5, -0.5, 4095.999, 4096.0, 1e10, np.nan)
    x[1, :2] = (np.inf, -np.inf)
    tiles = np.asarray(ns["call"](jnp.asarray(x)), np.int64)
    want = tiles.reshape(2, 64, 64).sum(0).reshape(-1)
    got = _port_counts(x, mode="clip_cast")
    np.testing.assert_array_equal(got, want)
    bins = np.clip(np.nan_to_num(x, nan=0.0).clip(-1e9, 1e9)
                   .astype(np.int64), 0, HB - 1)
    np.testing.assert_array_equal(got, _bincount(bins))


@pytest.mark.parametrize("source", ["arange", "random"])
def test_flatten_tile_matches_k_reshape(interpret, source):
    """One (64,128) tile to (8192,1), the experiment's pallas_call shapes;
    ``flatten_tile`` also takes several tiles at once."""
    ns = _experiment("exp_flatten_cost", {}, ("k_reshape",))
    r, lanes, p = ns["R"], ns["L"], ns["P"]
    call = pl.pallas_call(
        ns["k_reshape"], grid=(1,),
        in_specs=[pl.BlockSpec((r, lanes), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((p, 1), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((p, 1), jnp.float32))
    x = (np.arange(p, dtype=np.float32).reshape(r, lanes)
         if source == "arange" else np.random.default_rng(2).normal(
             size=(r, lanes)).astype(np.float32))
    want = np.asarray(call(jnp.asarray(x)))
    got = histogram.flatten_tile(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (p, 1)
    np.testing.assert_array_equal(got, want)
    two = histogram.flatten_tile(torch.as_tensor(np.stack([x, 2 * x])))
    np.testing.assert_array_equal(two.numpy()[p:], 2 * want)


# ---------------------------------------------------------------------------
# The spec binning against HistogramSpec.bin_index
# ---------------------------------------------------------------------------


SPEC = HistogramSpec(lo=300.0, hi=3000.0, n_bins=19998)


def _port_bins(v, spec=SPEC):
    return histogram.spec_bin_indices(
        torch.as_tensor(v), lo=spec.lo, log_lo=spec.log_lo,
        inv_w=1.0 / spec.width, n_bins=spec.n_bins).numpy()


def test_spec_bin_indices_match_bin_index_on_edge_values():
    """Exactly lo and one float32 ulp either side of it and of 49 cell
    edges, hi, 0, 1e-38, negative, huge, +inf and NaN: the cells of
    ``HistogramSpec.bin_index`` exactly (+inf and NaN land in cell 1, as
    XLA's saturating cast and int32 wrap-around put them)."""
    f32 = np.float32
    edges = np.exp(np.linspace(SPEC.log_lo, SPEC.log_hi, 49)).astype(f32)
    v = np.concatenate([
        np.array([SPEC.lo, np.nextafter(f32(SPEC.lo), f32(0)),
                  np.nextafter(f32(SPEC.lo), f32(np.inf)), SPEC.hi, 0.0,
                  1e-38, -1.0, 3e38, np.inf, np.nan], f32),
        edges, np.nextafter(edges, f32(0)), np.nextafter(edges, f32(np.inf))])
    want = np.asarray(SPEC.bin_index(jnp.asarray(v)))
    got = _port_bins(v)
    np.testing.assert_array_equal(got, want)
    assert list(got[[0, 1, 2, 4, 8, 9]]) == [1, 0, 1, 0, 1, 1]


def test_spec_bin_indices_match_bin_index_but_for_log_ulps():
    """On 200 000 log-uniform values the cells agree but where XLA's and
    torch's float32 log differ by an ulp at a cell edge (ROADMAP queue 3):
    each such value is within 2 ulps of log of an edge, and moves one
    cell."""
    rng = np.random.default_rng(4)
    v = np.exp(rng.uniform(np.log(250.0), np.log(3500.0), 200_000)).astype(
        np.float32)
    want = np.asarray(SPEC.bin_index(jnp.asarray(v)))
    got = _port_bins(v)
    diff = np.nonzero(got != want)[0]
    assert len(diff) < 50
    assert np.all(np.abs(got[diff] - want[diff]) == 1)
    logv = np.log(v[diff].astype(np.float64))
    x = (logv - SPEC.log_lo) / SPEC.width
    ulp = np.spacing(np.log(v[diff]).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(x - np.round(x)) * SPEC.width <= 2 * ulp)


@pytest.mark.parametrize("hb", [4096, 20000, 70000])
@pytest.mark.parametrize("mode", ["index", "clip_cast", "spec"])
def test_plain_modes_match_bincount(mode, hb):
    """Every mode's count equals np.bincount of its bins, indices outside
    [0, hb) dropped, at the kernel's three regimes of cells."""
    rng = np.random.default_rng(hb)
    n = 2 * 8192 + 77
    if mode == "index":
        x = rng.integers(-3, hb + 3, n).astype(np.int32)
        bins = x
        kw = {}
    elif mode == "clip_cast":
        x = rng.uniform(-40.0, hb + 40.0, n).astype(np.float32)
        bins = np.clip(x.astype(np.int32), 0, hb - 1)
        kw = {}
    else:
        spec = HistogramSpec(lo=300.0, hi=3000.0, n_bins=hb - 2)
        x = np.exp(rng.uniform(np.log(250.0), np.log(3500.0), n)).astype(
            np.float32)
        bins = _port_bins(x, spec)
        kw = dict(lo=spec.lo, log_lo=spec.log_lo, inv_w=1.0 / spec.width)
    got = histogram.histogram_counts(torch.as_tensor(x), hb, mode=mode, **kw)
    assert got.dtype == torch.int32 and got.shape == (hb,)
    np.testing.assert_array_equal(got.numpy(), _bincount(bins, hb))
    kept = bins[bins >= 0].astype(np.int64).clip(0, hb)
    np.testing.assert_array_equal(
        histogram.library_counts(torch.as_tensor(kept), hb).numpy(),
        _bincount(bins, hb))


def test_wrappers_take_the_plain_version_on_the_cpu_and_check_inputs():
    ce.reset_launch_counts()
    x = torch.zeros((8192,), dtype=torch.int32)
    assert int(histogram.histogram_counts(x, 5)[0]) == 8192
    histogram.flatten_tile(x.float().reshape(64, 128))
    assert sum(ce.LAUNCHES.values()) == 0
    with pytest.raises(TypeError):
        histogram.histogram_counts(x.float(), 5)
    with pytest.raises(ValueError, match="mode"):
        histogram.histogram_counts(x, 5, mode="bogus")
    with pytest.raises(ValueError, match="lo"):
        histogram.histogram_counts(x.float(), 5, mode="spec")
    with pytest.raises(ValueError, match="cells"):
        histogram.histogram_counts(x.float(), 2, mode="spec", lo=1.0,
                                   log_lo=0.0, inv_w=1.0)
    with pytest.raises(ValueError, match="tiles"):
        histogram.flatten_tile(x.float()[:4096].reshape(32, 128))
    with pytest.raises(ValueError, match="device"):
        histogram.histogram_launcher(x, 5)


# ---------------------------------------------------------------------------
# The probe reports and the bounds
# ---------------------------------------------------------------------------


def test_probe_reports_on_the_cpu():
    """``bench/probes.py`` on the plain versions: exact against
    np.bincount, row-major order kept, no device times."""
    hist = probes.hist_report(n=2 * 8192, device="cpu")
    assert hist["index_exact_vs_bincount"]
    assert hist["clip_cast_exact_vs_bincount"]
    assert hist["index_mass"] == hist["clip_cast_mass"] == 2 * 8192
    assert "index_ms" not in hist
    flat = probes.flatten_report(n_tiles=2, device="cpu")
    assert flat["row_major_order_kept"] and "ms" not in flat


def test_probes_entry_point_on_the_cpu(capsys):
    probes.main(["--device", "cpu", "--n", "8192"])
    out = capsys.readouterr().out.strip().splitlines()
    assert '"row_major_order_kept": true' in out[-1]


def test_histogram_bounds_are_bytes():
    """2^24 int32 inputs over 4096 cells: 64 MiB read once, bound by the
    bytes (0.020 ms at 3.35 TB/s); the flatten moves twice the bytes."""
    x = torch.zeros((1 << 24,), dtype=torch.int32)
    ms, by, work = roofline.bound("histogram_index", (x,), dict(hb=HB))
    assert by == "bytes" and work["bytes"] == (1 << 24) * 4 + HB * 4
    assert ms == pytest.approx(work["bytes"] / 3.35e12 * 1e3)
    assert 0.019 < ms < 0.021
    f = torch.zeros((1 << 24,), dtype=torch.float32)
    ms_spec, by, _ = roofline.bound("histogram", (f,), dict(hb=20002))
    assert by == "bytes" and ms_spec > ms
    ms_flat, by, work = roofline.bound("flatten_tile", (f,), {})
    assert by == "bytes" and work["bytes"] == 2 * (1 << 24) * 4
