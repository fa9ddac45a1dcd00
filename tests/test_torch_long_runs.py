"""The long-run entry points on the CPU at small sizes:
``bench/validation.py`` (three samplers against their exact laws, within
its own bars),
``bench/fault_drill.py --quick`` (a real child process killed with SIGKILL
after its third checkpointed chunk, resumed here and held to an
uninterrupted run bit for bit; the law over six seed segments), the
held-outputs check of ``bench/held_outputs.py`` on stand-in launchers, and
``engine/progress.py``."""

import io
import json

import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.bench import fault_drill, held_outputs
from stock_market_monte_carlo_torch.bench import validation
from stock_market_monte_carlo_torch.engine.progress import TerminalProgress


def test_validation_on_the_cpu(capsys):
    records = validation.main(["--device", "cpu", "--n", "16384",
                               "--months", "12"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [r["sampler"] for r in records] == list(validation.SAMPLERS)
    assert len(lines) == len(records)
    for line, rec in zip(lines, records):
        name = rec["sampler"]
        assert line.startswith(f"[validation] {name}: ")
        assert json.loads(line.split(": ", 1)[1]) == rec
        assert rec["ok"], rec
        assert rec["hist_mass"] == 16384
        assert [q["p"] for q in rec["quantiles"]] == list(validation.PS)
        assert rec["count_held"] == (name != "clt")
    clt = records[-1]["quantiles"]
    # the predicted block deviation: pulled in at the low tail, out at the
    # high one
    assert clt[0]["predicted"] > 0 > clt[-1]["predicted"]


def test_fault_drill_quick_on_the_cpu(capsys, monkeypatch):
    # the killed child runs torch on this worker's share of the cores
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    records = fault_drill.main(["--device", "cpu", "--quick"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "[fault_drill] fault", "[fault_drill] scale",
        "[fault_drill] checkpoint_cost"]
    fault = records["fault"]
    chunk = fault_drill.QUICK["chunk"]
    assert fault["exit_status"] == -9
    assert fault["reported"] == [chunk, 2 * chunk, 3 * chunk]
    assert fault["checkpoint_paths_done"] == 3 * chunk
    assert fault["stats_bit_equal"] and fault["hist_bit_equal"]
    assert fault["ok"], fault
    scale = records["scale"]
    assert scale["ok"], scale
    assert scale["terminal_law"]["seed_segments"] == 6
    assert scale["terminal_law"]["hist_mass"] == fault_drill.QUICK["law_n"]
    for rec in records["checkpoint_cost"].values():
        assert len(rec["walls_s"]["with"]) == fault_drill.PAIRS
        assert rec["saves"] == 4


def _stand_in(holds):
    """A launcher in the shape of the bare launchers: its kernel adds one
    to its output; ``holds`` says whether ``launch`` keeps the output."""
    def launcher(n):
        out = torch.zeros(n)
        if holds:
            def launch(held=(out,)):
                out.add_(1.0)
        else:
            def launch():
                out.add_(1.0)
        return launch, lambda: out
    return launcher


@pytest.mark.parametrize("holds", [True, False])
def test_held_outputs_check_tells_a_dropped_output(monkeypatch, holds):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(held_outputs, "_cases", lambda: {
        "stand_in": (_stand_in(holds), lambda dev: ((16,), {}))})
    ok, detail = held_outputs.check("stand_in", "cpu")
    assert ok is holds
    assert detail["held_by_launch"] is holds


def test_terminal_progress_counts_this_run_only():
    out = io.StringIO()
    bar = TerminalProgress(stream=out, min_interval_s=0.0)
    bar(500, 1000)      # the resumed paths, reported first
    bar(1000, 1000)
    text = out.getvalue()
    assert "1000/1000 simulations done (100.0%)" in text
    assert text.endswith("\n")
    assert bar._done0 == 500


def test_terminal_progress_on_a_resumed_run(tmp_path):
    """The engine reports a resumed run's paths first."""
    calls = []
    args = (smt.HistoricalBootstrap.from_csv(), 2 * 8192, 6)
    opts = smt.EngineOptions(device="cpu", chunk_paths=8192)
    path = str(tmp_path / "run.npz")
    smt.simulate_stats(*args, options=opts, checkpoint_path=path)
    bar = TerminalProgress(stream=io.StringIO(), min_interval_s=0.0)
    smt.simulate_stats(*args, options=opts, checkpoint_path=path,
                       progress=lambda d, t: (calls.append(d), bar(d, t)))
    assert calls == [2 * 8192, 2 * 8192] and bar._done0 == 2 * 8192
