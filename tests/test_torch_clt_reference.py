"""The gaussian-clt-prefix-pct cell's plain reference on the CPU
(``smmc_bench/reference/draws/counter_clt.py``): its growth rows are the
port's ``clt.prefix_growth`` bit for bit, a query reads inside the cell's
limits against the port's CPU ``simulate_stats`` under
``gaussian_sampler="clt-prefix"``, and four faults come out not correct:
the bfloat16 control, Q with two columns swapped, the ICDF draw in the
CLT draw's place and the stream without its family's XOR. Also the
frozen Q against the port's, the reference's imports, and the draw's
work count against the port's operation model. The card's test (marker
``gpu``, ``tests/test_torch_gpu.py``) holds the reference to the
kernel."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

from smmc_bench import cells, check, metrics, reference, run
from smmc_bench.program import Program
from smmc_bench.reference import stream
from smmc_bench.reference.draws import counter_clt
from stock_market_monte_carlo_torch.bench import roofline
from stock_market_monte_carlo_torch.ops import clt
from stock_market_monte_carlo_torch.ops import cuda_engine as port_ce

REPO = Path(__file__).resolve().parents[1]
CELL = "gaussian-clt-prefix-pct"
CONFIG = "gaussian_clt_100M_360"
# three stream tiles and a ragged fourth; 360 months: the third block
# partial
N_PATHS = 3 * counter_clt.TILE + 5
N_PERIODS = 360


def _cell():
    cfg = dict(cells.config(REPO, CONFIG), n_paths=N_PATHS)
    return cfg, cells.traffic(REPO, "stats_pct")


def _port_answer(seed):
    cfg, mix = _cell()
    prog = Program(cfg, mix, None, "cpu")
    return prog.answer(prog(seed))


def _judge(answer, seed, cfg=None):
    """The cell's judgement of ``answer`` against the reference."""
    cfg_, mix = _cell()
    ref = reference.query(cfg or cfg_, mix, None, seed, "cpu")
    return check.judge(check.gaps("stats", answer, ref, N_PATHS),
                       cells.limits(REPO, CELL))


@pytest.mark.parametrize("tile0", [0, 5])
def test_growth_rows_are_the_ports_prefix_growth(tile0):
    cfg, _ = _cell()
    model = cfg["model"]
    base = stream.seed_base(run.query_seed(2**31 + 3, 0))
    a, b = port_ce.gaussian_ab(model["args"]["mean_pct"],
                               model["args"]["std_pct"])
    arow, cs = clt.block_consts(a, b, N_PERIODS)
    # the reference's tiles hold 8192 paths, four stream tiles each
    port = list(clt.prefix_growth(
        clt.q_tensor("cpu"), torch.as_tensor(arow), torch.as_tensor(cs),
        seed_base=base ^ clt.CLT_STREAM_XOR,
        tile0=tile0 * (stream.TILE_PATHS // clt.CLT_P_STRATEGY),
        rows=torch.arange(N_PATHS)))
    growth = counter_clt.growth_fn(model, None, base, tile0, 1, "cpu")
    for t in range(N_PERIODS):
        ref = growth(t).reshape(-1)[:N_PATHS]
        assert torch.equal(ref, port[t // clt.CLT_K][:, t % clt.CLT_K]), t


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_reference_agrees_with_the_port(seed):
    s = run.query_seed(seed, 0)
    ok, rows = _judge(_port_answer(s), s)
    assert ok, rows


def test_control_fails():
    s = run.query_seed(5, 0)
    cfg, mix = _cell()
    ctl = reference.query(cfg, mix, None, s, "cpu", torch.bfloat16)
    ok, rows = _judge(ctl, s)
    assert not ok, rows


def test_swapped_q_columns_fail(monkeypatch):
    # Q with its first two columns swapped, under the vendored Q's
    # constants: a month's counts mixed by its neighbour's column, as a
    # kernel that stages Q's columns in the wrong order would
    q, colscale, colshift = counter_clt.qmatrix()
    swapped = q[:, [1, 0, *range(2, clt.CLT_K)]]
    monkeypatch.setattr(counter_clt, "qmatrix",
                        lambda: (swapped, colscale, colshift))
    s = run.query_seed(7, 0)
    ok, rows = _judge(_port_answer(s), s)
    assert not ok, rows


def test_icdf_draw_in_the_clt_draws_place_fails():
    s = run.query_seed(9, 0)
    cfg, _ = _cell()
    icdf = dict(cfg, model=dict(cfg["model"], draw="counter_gaussian"))
    ok, rows = _judge(_port_answer(s), s, icdf)
    assert not ok, rows


def test_stream_without_its_xor_fails(monkeypatch):
    monkeypatch.setattr(counter_clt, "STREAM_XOR", 0)
    s = run.query_seed(11, 0)
    ok, rows = _judge(_port_answer(s), s)
    assert not ok, rows


def test_frozen_q_is_the_ports():
    ours = (REPO / "smmc_bench" / "data" / "clt_q128.npy").read_bytes()
    assert ours == (REPO / "stock_market_monte_carlo_torch" / "ops"
                    / "_clt_q128.npy").read_bytes()
    q, colscale, colshift = counter_clt.qmatrix()
    bits, port_scale, port_shift = clt.clt_qmatrix()
    assert torch.equal(q.to(torch.bfloat16).view(torch.int16),
                       torch.from_numpy(bits.view(np.int16)))
    assert colscale.tobytes() == port_scale.tobytes()
    assert colshift.tobytes() == port_shift.tobytes()


def test_reference_imports_neither_package():
    code = ("import sys, smmc_bench.reference.draws.counter_clt; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'stock_market_monte_carlo_torch', "
            "'stock_market_monte_carlo_tpu', 'jax', 'jaxlib'}))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_work_is_within_the_ports_clt_prefix_count(monkeypatch):
    n = 1 << 24
    cfg = dict(cells.config(REPO, CONFIG), n_paths=n)
    mix = cells.traffic(REPO, "stats_pct")
    ours = run.query_work(REPO, cfg, mix)
    draw = cells.load_module(REPO, "work", "clt_draw").work(cfg, mix)
    monkeypatch.setattr(port_ce, "_sm_count", lambda device: 132)
    nblocks = -(-N_PERIODS // clt.CLT_K)
    ops = (torch.zeros((clt.CLT_K, clt.CLT_K), dtype=torch.bfloat16),
           torch.zeros((nblocks, clt.CLT_K)), torch.zeros((nblocks,
                                                            clt.CLT_K)),
           torch.zeros((nblocks, clt.CLT_K)))
    kw = dict(variant="prefix", valid=n,
              hb=mix["options"]["histogram_bins"] + 2, keep_finals=False)
    ms, by, theirs = roofline.bound("clt", ops, kw)
    assert by == "operations"
    assert draw["tensor_flop"] == theirs["tensor_flop"]
    # the bounds err low: the port's model counts the kernel's prefix
    assert ours["scalar_ops"] <= theirs["scalar_ops"]
    assert metrics.least_seconds(ours) * 1e3 <= ms
