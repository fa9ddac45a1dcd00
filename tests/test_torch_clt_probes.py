"""The CLT probes' plain versions against the experiments' own Pallas
kernels, on the CPU: the op-class toys (``experiments/exp_clt_roofline.py``),
the ablation (``exp_clt_ablate.py``) and the tile grouping
(``exp_clt_ts2.py``).

``exp_clt_roofline.py`` keeps its work under ``main()``, so it is loaded by
path, with ``GRID`` cut to 2 tiles. The other two assert a TPU backend and
measure when imported: their kernel functions, upper-case constants and
``pl.pallas_call`` statements are compiled out of the syntax tree
(``test_torch_histogram._experiment``), at 2 grid steps; the names the
files import from the JAX package, and their lower-case inputs (Q and its
column constants, the histogram spec, ``nblocks``), are supplied here.
``pl.pallas_call`` runs in interpret mode, and the hardware PRNG is the
counter stream the port draws: ``prng_seed`` resets a call counter and
``prng_random_bits`` returns ``pallas_engine._arith_bits(seed, calls++,
shape)``, so block j of a tile draws key j (``_TileRng`` under "arith").
All patches go through ``monkeypatch``; neither the JAX package nor
``experiments/`` is touched.
"""

import ast
import functools
import importlib.util
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
from stock_market_monte_carlo_torch.ops import calibration as cal
from stock_market_monte_carlo_torch.ops import clt
from stock_market_monte_carlo_torch.ops import cuda_engine as ce
from stock_market_monte_carlo_tpu.engine.engine import make_histogram_spec
from stock_market_monte_carlo_tpu.models.market import GaussianReturns
from stock_market_monte_carlo_tpu.models.strategies import NoWithdrawal
from stock_market_monte_carlo_tpu.ops import pallas_engine as pe
from test_torch_histogram import _experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# mm toy: the chain re-rounds x to bf16 every pass, so an accumulation-
# order ulp that lands on a bf16 rounding edge becomes a 2^-8 step in that
# element, which Q spreads over the row: the bar is relative to the row's
# largest magnitude; an edge hit moves a row by ~2^-8 * |Q| ~ 3e-4 of it.
# Measured (no edge hit at these inputs): 1.6e-7 against XLA on the CPU,
# 1.6e-7 of the kernel against the plain version on an H100 (64 tiles).
MM_ROW_REL = 1e-3
# the ablated finals: test_torch_gaussian's CLT bar (the bf16 product and
# the row sums in another order, log/exp an ulp apart)
CLT_REL = 5e-6
# power sums of 4096 float32 terms a tile, summed in float32 by XLA (its
# order) and in float64 by the port, of finals within CLT_REL
SUMS_REL = 2e-5
SEED_ABLATE, SEED_TS2 = 99, 77     # the experiments' iscal[0]
N_STEPS = 2


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "experiments", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def stream(monkeypatch):
    """Interpret-mode Pallas with the counting counter-stream stub."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    state = {}

    def prng_seed(seed):
        state.update(seed=seed, calls=0)

    def prng_random_bits(shape):
        key = state["calls"]
        state["calls"] += 1
        return pe._arith_bits(state["seed"], jnp.int32(key), shape)

    monkeypatch.setattr(pltpu, "prng_seed", prng_seed)
    monkeypatch.setattr(pltpu, "prng_random_bits", prng_random_bits)


# ---------------------------------------------------------------------------
# 12b: the op-class toys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", cal.EXPERIMENT_OPS)
def test_op_toy_matches_exp_clt_roofline(stream, monkeypatch, op):
    """mul, iadd, shf, cvt bit for bit (exact, or small integers in bf16);
    fma within an ulp (XLA on the CPU may contract a + x*c, ROADMAP queue
    3); mm within MM_ROW_REL of the row's scale."""
    exp = _load("exp_clt_roofline")
    monkeypatch.setattr(exp, "GRID", 2)
    fscal = jnp.asarray([1.0000001, 0.0000002, 0, 0, 0, 0, 0, 0],
                        jnp.float32)
    args = (fscal, exp._clt_qmatrix(128)[0]) if op == "mm" else (fscal,)
    want = np.asarray(jax.jit(exp._make_toy(op))(*args))
    got = cal.op_toy_chunk(op, 2, device="cpu").numpy()
    assert got.shape == want.shape == (2 * 8, 128)
    if op == "mm":
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert (np.abs(got - want) <= MM_ROW_REL * scale).all()
        assert len(np.unique(want[0])) > 100    # the columns are mixed
    elif op == "fma":
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:
        np.testing.assert_array_equal(got, want)


def test_op_toy_values_and_checks():
    """The integer classes' closed forms, the hash class against the
    counter word's finalizer, and the wrapper's checks; no launch on the
    CPU."""
    ce.reset_launch_counts()
    want = {"iadd": 3.0 + 12, "shf": 2.0, "cvt": sum(range(3, 15)) + 15.0}
    for op, value in want.items():
        assert bool((cal.op_toy_chunk(op, 1, device="cpu") == value).all())
    xi = 3
    for _ in range(cal.TOY_PASSES):
        xi = int(ce._finalize(torch.tensor(
            (xi + ce._GOLDEN) & ce.MASK32)))
    assert bool((cal.op_toy_chunk("hash", 1, device="cpu")
                 == float(xi >> 8)).all())
    assert sum(ce.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="op class"):
        cal.op_toy_chunk_plain("div", 1)
    with pytest.raises(ValueError, match="n_tiles"):
        cal.op_toy_chunk_plain("mul", 0)
    with pytest.raises(ValueError, match="int32"):
        cal.op_toy_chunk_plain("shf", 1, xi0=1 << 31)


@pytest.mark.parametrize("xi0", cal.TOY_SHF_HARD_XI0)
def test_shf_toy_from_hard_starts(xi0):
    """The plain shf toy from a start with bit 31 set (or the largest
    int32) against a numpy twin on uint32: a logical shift, so the top bit
    comes in as 0; written as int32."""
    x = np.uint32(xi0 & 0xFFFFFFFF)
    for _ in range(cal.TOY_PASSES):
        x = (x >> np.uint32(1)) + np.uint32(cal.TOY_CI)
    want = np.float32(np.array(x).view(np.int32))
    got = cal.op_toy_chunk_plain("shf", 1, xi0=xi0)
    assert got.shape == (cal.TOY_OUT_ROWS, 128)
    assert bool((got == float(want)).all())


def _bf16_of_torch_and_xla(xi):
    """int32 values cast to bfloat16 by torch (from int64) and by XLA on
    the CPU (``astype``), as float32 arrays."""
    by_torch = torch.as_tensor(xi, dtype=torch.int64).to(torch.bfloat16)
    by_xla = jnp.asarray(np.asarray(xi, np.int32)).astype(jnp.bfloat16)
    return (by_torch.to(torch.float32).numpy(),
            np.asarray(by_xla).astype(np.float32))


def test_cvt_twin_matches_torch_and_xla_about_2_22():
    """The cvt kernel's conversion, step by step (cal.cvt_bf16_twin), on
    every int in [-2^22, 2^22], bit for bit against torch's and XLA's
    int-to-bf16 casts."""
    xi = np.arange(-(1 << 22), (1 << 22) + 1, dtype=np.int64)
    got = cal.cvt_bf16_twin(torch.from_numpy(xi)).numpy()
    by_torch, by_xla = _bf16_of_torch_and_xla(xi)
    np.testing.assert_array_equal(got, by_torch)
    np.testing.assert_array_equal(got, by_xla)


def test_cvt_twin_matches_torch_and_xla_on_witnesses():
    """The conversion up to 2^31 - 1, bit for bit against torch and XLA:
    the card tests' starts and their chains, a value that rounds twice
    (2^24 + 2^16 + 1 goes to 2^24 through float32, to 2^24 + 2^17 in one
    rounding), ties and carries at every binade past 2^24, and 2^20 draws
    over int32; then the plain toy from each start against a bf16 sum of
    the twin's values, and the plain toy's int32 check."""
    rng = np.random.default_rng(17)
    starts = np.asarray(cal.TOY_CVT_HARD_XI0, np.int64)
    ties = [(1 << b) + (1 << (b - 8)) * m + d for b in range(24, 31)
            for m in (1, 3) for d in (-1, 0, 1)]
    xi = np.concatenate([
        (starts[:, None] + np.arange(cal.TOY_PASSES + 1)).ravel(),
        np.asarray(ties), -np.asarray(ties), [2**31 - 1, -(2**31)],
        rng.integers(-(2**31), 2**31, 1 << 20)])
    got = cal.cvt_bf16_twin(torch.from_numpy(xi)).numpy()
    by_torch, by_xla = _bf16_of_torch_and_xla(xi)
    np.testing.assert_array_equal(got, by_torch)
    np.testing.assert_array_equal(got, by_xla)
    witness = torch.tensor([16842753])
    assert float(cal.cvt_bf16_twin(witness)) == 2.0**24
    assert int(cal._round_bits(witness, 8)) == 2**24 + 2**17
    for x0 in cal.TOY_CVT_HARD_XI0:
        bacc = torch.zeros((), dtype=torch.bfloat16)
        for p in range(cal.TOY_PASSES):
            bacc = bacc + cal.cvt_bf16_twin(torch.tensor(x0 + p)).to(
                torch.bfloat16)
        want = float(bacc.float() + torch.tensor(x0 + cal.TOY_PASSES,
                                                 dtype=torch.float32))
        assert bool((cal.op_toy_chunk_plain("cvt", 1, xi0=x0)
                     == want).all())
    with pytest.raises(ValueError, match="int32"):
        cal.op_toy_chunk_plain("cvt", 1, xi0=(1 << 31) - 12)


# ---------------------------------------------------------------------------
# 12c, 12d: the ablation and the tile grouping
# ---------------------------------------------------------------------------


def _inputs():
    """The experiments' Q, column constants and histogram spec, built here
    (the files build them at import)."""
    q_np, cs_np, sh_np = pe._clt_qmatrix(128)
    spec = make_histogram_spec(GaussianReturns(), NoWithdrawal(), 360,
                               1000.0, 4094)
    return q_np, cs_np, sh_np, spec


def _scalars(seed, n_paths, spec):
    iscal = jnp.asarray([seed, 0, n_paths, 0, 0, 0, 0, 0], jnp.int32)
    fscal = jnp.stack([jnp.float32(1000.0), jnp.float32(1.005),
                       jnp.float32(1.0 / 120.0), jnp.float32(0),
                       jnp.float32(2000.0), jnp.float32(spec.log_lo),
                       jnp.float32(1.0 / spec.width), jnp.float32(0)])
    return iscal, fscal


def _extra(q_np, cs_np, sh_np, spec):
    return dict(N_PARTIAL_ROWS=pe.N_PARTIAL_ROWS,
                _tile_seed_i32=pe._tile_seed_i32, nblocks=3, q_np=q_np,
                cs_np=cs_np, sh_np=sh_np, spec=spec)


def _call_statement(name):
    """The file's ``call = pl.pallas_call(...)`` statement, compiled."""
    with open(os.path.join(REPO, "experiments", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "call"):
            return compile(ast.Module([node], type_ignores=[]), name, "exec")
    raise AssertionError(f"no call statement in {name}")


def _jax_outputs(call, iscal, fscal, q_np, cs_np, sh_np):
    """(finals, per-tile partial rows (tiles, 8), summed histogram) of one
    run of the experiment's pallas_call."""
    finals, partials, hist = (np.asarray(x) for x in jax.jit(call)(
        iscal, fscal, jnp.asarray(q_np), jnp.asarray(cs_np),
        jnp.asarray(sh_np)))
    rows = partials.reshape(-1, pe.N_PARTIAL_ROWS, 128)[:, :, 0]
    return finals[:, 0], rows, hist.reshape(-1, 4096).sum(0)


_JAX = {}


def _jax_ablate(variant):
    """The experiment's kernel of ``variant`` at N_STEPS tiles (cached:
    each variant compiles once a process)."""
    if variant not in _JAX:
        q_np, cs_np, sh_np, spec = _inputs()
        ns = _experiment("exp_clt_ablate", dict(NT=N_STEPS), ("make_kernel",),
                         extra=_extra(q_np, cs_np, sh_np, spec))
        ns["variant"] = variant
        exec(_call_statement("exp_clt_ablate"), ns)
        iscal, fscal = _scalars(SEED_ABLATE, N_STEPS * clt.CLT_P, spec)
        _JAX[variant] = _jax_outputs(ns["call"], iscal, fscal, q_np, cs_np,
                                     sh_np)
    return _JAX[variant]


def _port(ablate, seed, n_paths, tiles_per_block=0):
    _, _, _, spec = _inputs()
    arow, cs = clt.block_consts(np.float32(1.005), np.float32(1.0 / 120.0),
                                360)
    stats, hist, finals = clt.clt_probe_chunk(
        clt.q_tensor("cpu"), torch.as_tensor(arow), torch.as_tensor(cs),
        ablate=ablate, tiles_per_block=tiles_per_block, seed_base=seed,
        tile0=0, valid=n_paths, n_paths=n_paths, v0=1000.0, target=2000.0,
        lo=spec.lo, log_lo=spec.log_lo, inv_w=1.0 / spec.width, hb=4096,
        with_hist=True, keep_finals=True)
    return stats.numpy(), hist.numpy(), finals.numpy()


def _assert_matches(port, jax_out, target=2000.0):
    """Finals at CLT_REL; histogram and counts below exact but for the
    finals an ulp move may carry across a cell edge or the target; min and
    max at CLT_REL; power sums at SUMS_REL."""
    stats, hist, finals = port
    f_jax, rows, h_jax = jax_out
    np.testing.assert_allclose(finals, f_jax, rtol=CLT_REL, atol=0)
    assert stats[0] == f_jax.size
    assert hist.sum() == h_jax.sum() in (0, f_jax.size)   # 0: nohist
    assert np.abs(hist - h_jax).max() <= 2
    near = int(np.sum(np.abs(f_jax / target - 1.0) <= CLT_REL))
    assert abs(stats[7] - rows[:, 6].sum()) <= near
    assert stats[5] == pytest.approx(rows[:, 4].min(), rel=CLT_REL)
    assert stats[6] == pytest.approx(rows[:, 5].max(), rel=CLT_REL)
    np.testing.assert_allclose(stats[1:5],
                               rows[:, :4].astype(np.float64).sum(0),
                               rtol=SUMS_REL)
    assert stats[8] == rows[:, 7].sum() == 0.0


@pytest.mark.parametrize("ablate", list(clt.ABLATIONS))
def test_ablation_matches_exp_clt_ablate(stream, ablate):
    """Each variant of ``make_kernel`` (``base`` for the experiment's
    ``base``) against ``clt_probe_chunk_plain``, seed 99, 2 tiles."""
    jax_out = _jax_ablate(ablate)
    port = _port(ablate, SEED_ABLATE, N_STEPS * clt.CLT_P)
    _assert_matches(port, jax_out)
    if ablate == "nohist":
        assert not port[1].any() and not jax_out[2].any()


def test_ablations_differ_where_they_should(stream):
    """nodraw and nomm change every final, nologexp too; nohist changes
    none (only the histogram)."""
    base = _port("base", SEED_ABLATE, 8192)
    for ablate in ("nodraw", "nomm", "nologexp"):
        assert (_port(ablate, SEED_ABLATE, 8192)[2] != base[2]).mean() > 0.99
    nohist = _port("nohist", SEED_ABLATE, 8192)
    np.testing.assert_array_equal(nohist[2], base[2])
    np.testing.assert_array_equal(nohist[0], base[0])


def test_grouping_matches_exp_clt_ts2(stream):
    """``kernel_ts2`` (two tiles a grid step, seed 77) at 2 steps against
    the plain version at tiles_per_block 2 and 0: the same finals."""
    q_np, cs_np, sh_np, spec = _inputs()
    ts = 2
    ns = _experiment("exp_clt_ts2", dict(B=N_STEPS * ts * clt.CLT_P),
                     ("kernel_ts2", "call"),
                     extra=_extra(q_np, cs_np, sh_np, spec))
    assert ns["NSTEPS"] == N_STEPS and ns["TS"] == ts
    n = N_STEPS * ts * clt.CLT_P
    iscal, fscal = _scalars(SEED_TS2, n, spec)
    jax_out = _jax_outputs(ns["call"], iscal, fscal, q_np, cs_np, sh_np)
    port = _port("base", SEED_TS2, n, tiles_per_block=ts)
    _assert_matches(port, jax_out)
    other = _port("base", SEED_TS2, n, tiles_per_block=0)
    assert all(np.array_equal(a, b) for a, b in zip(port, other))


def test_probe_base_is_the_production_plain_variant():
    """The base probe's finals are clt_chunk_plain's (plain variant) bit
    for bit; its stats are the raw sums of them."""
    arow, cs = (torch.as_tensor(x) for x in clt.block_consts(
        np.float32(1.005), np.float32(1.0 / 120.0), 360))
    kw = dict(seed_base=5, tile0=3, valid=8000, n_paths=8192, v0=1000.0,
              target=1100.0, lo=100.0, log_lo=float(np.log(100.0)),
              inv_w=100.0, hb=4096, with_hist=True, keep_finals=True)
    q = clt.q_tensor("cpu")
    stats, hist, finals = clt.clt_probe_chunk(q, arow, cs, ablate="base",
                                              **kw)
    _, want_hist, want = clt.clt_chunk(q, arow, cs, None, variant="plain",
                                       shift=0.0, **kw)
    assert stats.dtype == torch.float64
    assert torch.equal(finals, want) and torch.equal(hist, want_hist)
    f = finals.double()
    assert float(stats[1]) == pytest.approx(float(f.sum()), rel=1e-12)
    assert float(stats[5]) == float(f.min()) and float(stats[7]) == float(
        (finals < 1100.0).sum())
    with pytest.raises(ValueError, match="ablation"):
        clt.clt_probe_chunk(q, arow, cs, ablate="nothing", **kw)
    with pytest.raises(ValueError, match="tiles_per_block"):
        clt.clt_probe_chunk(q, arow, cs, ablate="base", tiles_per_block=-1,
                            **kw)


# ---------------------------------------------------------------------------
# Reports and bounds
# ---------------------------------------------------------------------------


def test_clt_reports_on_the_cpu():
    """The three reports through the plain versions: no times, the
    experiments' other quantities."""
    toys = probes.clt_toys_report(n_tiles=2, device="cpu")
    assert set(toys["classes"]) == set(cal.TOY_OPS)
    assert toys["classes"]["iadd"]["checksum"] == 2 * 8 * 128 * 15.0
    assert "ms" not in toys["classes"]["mul"]
    ablation = probes.clt_ablation_report(n_paths=8192, device="cpu")
    assert set(ablation["variants"]) == set(clt.ABLATIONS)
    assert ablation["variants"]["nohist"]["hist_mass"] == 0
    assert ablation["variants"]["base"]["hist_mass"] == 8192
    grouping = probes.clt_grouping_report(n_paths=16384, device="cpu")
    assert grouping["identical_to_ts0"] == {str(t): True
                                            for t in clt.GROUPINGS[1:]}
    assert grouping["power_sums_max_rel_diff"] == 0.0


def test_probe_bounds(monkeypatch):
    """The toys' bounds: mul 12 x 2^31 FMUL at the issue rate (0.77 ms),
    mm 12 x 2^31 x 256 flop on the tensor cores (6.7 ms); the ablation's
    bounds are the CLT's with the removed part taken out (an H100's 132
    SMs give the partial rows' count)."""
    monkeypatch.setattr(ce, "_sm_count", lambda device: 132)
    n_tiles = cal.TOY_TILES
    ms, by, w = roofline.bound("op_toy_mul", ("mul",), dict(n_tiles=n_tiles))
    assert w["scalar_ops"] == 12 * 2.0**31 and by == "operations"
    assert ms == pytest.approx(0.770, rel=1e-3)
    ms, by, w = roofline.bound("op_toy_mm", ("mm",), dict(n_tiles=n_tiles))
    assert w["tensor_flop"] == 12 * 2.0**31 * 256
    assert ms == pytest.approx(6.671, rel=1e-3)
    arow, cs = (torch.as_tensor(x) for x in clt.block_consts(
        np.float32(1.005), np.float32(0.04), 360))
    ops = (clt.q_tensor("cpu"), arow, cs, None)
    kw = dict(valid=1 << 20, n_paths=1 << 20, hb=4096, keep_finals=False,
              variant="plain")
    full = roofline.work("clt", ops, kw)
    assert full["tensor_flop"] > 0
    for ablate in clt.ABLATIONS:
        w = roofline.work(f"clt_probe_{ablate}", ops[:3],
                          dict(kw, ablate=ablate))
        assert (w["tensor_flop"] == 0) == (ablate == "nomm")
        if ablate in ("base", "nomm"):
            assert w["scalar_ops"] == full["scalar_ops"]
        else:
            assert w["scalar_ops"] < full["scalar_ops"]
