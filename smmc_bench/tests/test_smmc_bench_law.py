"""The terminal-law cell's plain reference on the CPU: its operand is the
port's fit bit for bit, its finals are the port's plain law within an ulp,
a query reads inside the cell's limits against the port's CPU
``simulate_stats(terminal_law=True)``, and the bfloat16 control and a law
one coefficient off come out not correct. Also the configuration's law
entry and the work counts against the port's operation model. The card's
test (marker ``gpu``) holds the reference to the law kernel."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import stock_market_monte_carlo_torch as smt
from smmc_bench import cells, check, metrics, reference, run
from smmc_bench.program import Program
from smmc_bench.reference import law_fit, stream
from smmc_bench.reference.draws import counter_law
from smmc_bench.tests._tiny import REPO, load, tiny_root
from stock_market_monte_carlo_torch.bench import roofline
from stock_market_monte_carlo_torch.ops import cuda_engine as port_ce
from stock_market_monte_carlo_torch.ops import terminal_law as port_law

CELL = "historical-law"
CONFIG = "historical_law_1B_360"
# three tiles and a ragged fourth
N_PATHS = 3 * 8192 + 777


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # the law's fit is the 360-month one: only the paths are cut
    return tiny_root(tmp_path_factory.mktemp("law"), N_PATHS, 360)


@pytest.fixture(scope="module")
def operand():
    cfg = cells.config(REPO, CONFIG)
    fit = port_law.fit_terminal_law(
        smt.HistoricalBootstrap(cells.read_table(REPO, cfg)),
        smt.NoWithdrawal(), 360, 1000.0)
    return fit.operand()


def test_operand_is_the_ports_fit(operand):
    cfg = cells.config(REPO, CONFIG)
    ref = counter_law.operand(cfg["model"]["table"],
                              cfg["model"]["table_rows"], 360, 1000.0)
    assert ref.dtype == np.float32 and ref.shape == (law_fit.LAW_D + 1,)
    assert ref.tobytes() == operand.tobytes()


@pytest.mark.parametrize("tile0", [0, 5])
def test_finals_are_the_ports_plain_law(tile0):
    cfg = cells.config(REPO, CONFIG)
    model = dict(cfg["model"])
    seed = run.query_seed(2**31 + 3, 0)
    base = stream.seed_base(seed)
    n_tiles = -(-N_PATHS // stream.TILE_PATHS)
    law = torch.as_tensor(counter_law.operand(
        model["table"], model["table_rows"], 360, 1000.0))
    _, _, port = port_ce.law_chunk_plain(
        law, seed_base=base ^ port_ce.LAW_STREAM_XOR, tile0=tile0,
        valid=N_PATHS, n_paths=n_tiles * stream.TILE_PATHS, v0=1000.0,
        target=2000.0, shift=0.0, inv_zmax=1.0 / port_law.LAW_ZMAX, lo=1.0,
        log_lo=0.0, inv_w=1.0, hb=4096, with_hist=False, keep_finals=True)
    v = counter_law.finals(model, base, tile0, n_tiles, "cpu").reshape(-1)
    assert torch.equal(v[:N_PATHS], port)
    growth = counter_law.growth_fn(model, None, base, tile0, n_tiles, "cpu")
    assert all(torch.equal(growth(t), torch.ones_like(growth(0)))
               for t in (1, 359))
    finals = (stream.f32(1000.0) * growth(0)).reshape(-1)[:N_PATHS]
    ulp = torch.abs(torch.nextafter(port, torch.full_like(port, np.inf))
                    - port)
    assert torch.all(torch.abs(finals - port) <= ulp)


def _gaps(root, program_answer, seed, dtype=torch.float32):
    cfg, mix, table = load(root, CELL)
    ref = reference.query(cfg, mix, table, seed, "cpu")
    if program_answer is None:
        program_answer = reference.query(cfg, mix, table, seed, "cpu", dtype)
    return check.judge(check.gaps("stats", program_answer, ref, N_PATHS),
                       cells.limits(REPO, CELL))


def _port_answer(root, seed):
    cfg, mix, table = load(root, CELL)
    prog = Program(cfg, mix, table, "cpu")
    return prog.answer(prog(seed))


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_reference_agrees_with_the_port(root, seed):
    s = run.query_seed(seed, 0)
    ok, rows = _gaps(root, _port_answer(root, s), s)
    assert ok, rows


def test_control_fails(root):
    s = run.query_seed(5, 0)
    ok, rows = _gaps(root, None, s, torch.bfloat16)
    assert not ok, rows


# c_0 shifts every log V_T; c_5 bends the quantile function
@pytest.mark.parametrize("index", [1, 6])
def test_a_coefficient_off_fails(root, index, monkeypatch):
    fit = port_law.fit_terminal_law

    def off(*a, **kw):
        good = fit(*a, **kw)
        coefs = good.coefs.copy()
        coefs[index - 1] += np.float32(1e-3)
        return dataclasses.replace(good, coefs=coefs)
    monkeypatch.setattr(port_law, "fit_terminal_law", off)
    s = run.query_seed(7, 0)
    ok, rows = _gaps(root, _port_answer(root, s), s)
    assert not ok, rows


def test_config_law_is_its_horizon_and_capital():
    cfg = json.loads((REPO / "smmc_bench" / "configs"
                      / f"{CONFIG}.json").read_text())
    assert cfg["model"]["law"] == dict(n_periods=cfg["n_periods"],
                                       initial_capital=cfg["initial_capital"])
    assert cfg["engine_options"]["terminal_law"] is True


def test_work_is_the_ports_law_count(monkeypatch):
    cfg = dict(cells.config(REPO, CONFIG), n_paths=1 << 24)
    mix = cells.traffic(REPO, "stats_law")
    ours = run.query_work(REPO, cfg, mix)
    monkeypatch.setattr(port_ce, "_sm_count", lambda device: 132)
    kw = dict(valid=1 << 24, hb=mix["options"]["histogram_bins"] + 2,
              keep_finals=False)
    ms, by, theirs = roofline.bound(
        "law", (torch.zeros(law_fit.LAW_D + 1),), kw)
    assert by == "operations"
    assert ours["scalar_ops"] == pytest.approx(theirs["scalar_ops"],
                                               rel=1e-12)
    assert metrics.least_seconds(ours) * 1e3 == pytest.approx(ms, rel=0.01)
    assert ms == pytest.approx(0.1068, abs=5e-5)


@pytest.mark.gpu
def test_reference_against_the_law_kernel(tmp_path):
    """On the card: a chunk and a ragged second one of the law kernel
    against the reference, and the control failing the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tiny_root(tmp_path, (1 << 24) + 20000, 360)
    cfg, mix, table = load(root, CELL)
    prog = Program(cfg, mix, table, "cuda")
    answer = prog.answer(prog(2**31 + 9))
    ref = reference.query(cfg, mix, table, 2**31 + 9, "cuda")
    ctl = reference.query(cfg, mix, table, 2**31 + 9, "cuda",
                          torch.bfloat16)
    n, limits = int(cfg["n_paths"]), cells.limits(REPO, CELL)
    ok, rows = check.judge(check.gaps("stats", answer, ref, n), limits)
    assert ok, rows
    ok, rows = check.judge(check.gaps("stats", ctl, ref, n), limits)
    assert not ok, rows
