"""Checkpoint and resume in the port's engine (``engine/checkpoint.py``),
on the CPU, modelled on tests/test_checkpoint.py: an interrupted run
resumed from its checkpoint equals an uninterrupted one bit for bit (the
historical and Gaussian ICDF month loops, the terminal law, a run over
seed segments); a completed checkpoint short-circuits; a checkpoint of
another run refuses, including one the JAX package wrote for the same
arguments. Across topologies: a checkpoint of a 2-rank gloo mesh run
resumes on one device and one of a single-device run on a 3-rank mesh
(spawned ranks, ``parallel/_ranks.py``), bit for bit at the same
``chunk_paths`` and with exact counts and cells and the moments within
1e-6 at another."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import checkpoint as ckpt
from stock_market_monte_carlo_torch.parallel._ranks import run_ranks
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions

TILE = 8192
CPU = dict(device="cpu", chunk_paths=TILE)
HIST = smt.HistoricalBootstrap.from_csv()
GAUSS = smt.GaussianReturns(mean_pct=0.5, std_pct=10.0 / 12)
SAMPLERS = {
    "historical": (HIST, smt.EngineOptions(**CPU)),
    "icdf": (GAUSS, smt.EngineOptions(**CPU)),
    "law": (HIST, smt.EngineOptions(terminal_law=True, **CPU)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests compare CPU runs bit for bit; under heavy CPU load the
    plain version's bin log was seen to round an edge value differently
    on several threads (ROADMAP queue 3, F5), never on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Stop(Exception):
    pass


def _interrupted(model, n, t, path, after, **kw):
    """Run with a checkpoint and a progress callback that raises on its
    ``after``-th call: the checkpoint then holds ``after`` chunks."""
    calls = []

    def interrupt(done, total):
        calls.append(done)
        if len(calls) == after:
            raise Stop()

    with pytest.raises(Stop):
        smt.simulate_stats(model, n, t, checkpoint_path=path,
                           progress=interrupt, **kw)
    return calls


def _assert_identical(got, want):
    assert got.moments == want.moments
    np.testing.assert_array_equal(got.histogram_counts,
                                  want.histogram_counts)


def _fingerprint(path):
    with np.load(path) as z:
        return bytes(z["fingerprint"]).decode()


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_resume_equals_uninterrupted(tmp_path, sampler):
    model, opts = SAMPLERS[sampler]
    n, t = 4 * TILE + 777, 24
    path = str(tmp_path / "run.npz")
    kw = dict(seed=3, target_amount=1200.0, options=opts)
    calls = _interrupted(model, n, t, path, 2, **kw)
    assert calls == [TILE, 2 * TILE]
    state = ckpt.load(path, _fingerprint(path))
    assert state.paths_done == 2 * TILE and state.next_offset == 2 * TILE
    seen = []
    resumed = smt.simulate_stats(model, n, t, checkpoint_path=path,
                                 progress=lambda d, _: seen.append(d), **kw)
    # the resumed paths first, then each chunk after them
    assert seen == [2 * TILE, 3 * TILE, 4 * TILE, n]
    _assert_identical(resumed, smt.simulate_stats(model, n, t, **kw))
    assert resumed.moments.n == n


def test_segmented_resume_equals_uninterrupted(tmp_path):
    """Five chunks over segments of two: interrupted after the third chunk,
    inside the second segment, the resume starts at its offset 8192 under
    the segment's own stream."""
    opts = smt.EngineOptions(seed_segment_paths=2 * TILE, **CPU)
    n, t = 5 * TILE, 12
    path = str(tmp_path / "seg.npz")
    kw = dict(seed=9, target_amount=1100.0, options=opts)
    _interrupted(HIST, n, t, path, 3, **kw)
    state = ckpt.load(path, _fingerprint(path))
    assert state.paths_done == 3 * TILE
    resumed = smt.simulate_stats(HIST, n, t, checkpoint_path=path, **kw)
    _assert_identical(resumed, smt.simulate_stats(HIST, n, t, **kw))


def test_completed_checkpoint_short_circuits(tmp_path):
    n, t = 2 * TILE, 12
    path = str(tmp_path / "run.npz")
    opts = smt.EngineOptions(**CPU)
    first = smt.simulate_stats(GAUSS, n, t, seed=1, options=opts,
                               checkpoint_path=path)
    seen = []
    again = smt.simulate_stats(GAUSS, n, t, seed=1, options=opts,
                               checkpoint_path=path,
                               progress=lambda d, _: seen.append(d))
    assert seen == [n, n]     # the resumed paths, then the end; no chunk
    _assert_identical(again, first)


def _other_runs():
    opts = smt.EngineOptions(**CPU)
    sobol = smt.SobolGaussianReturns.create(n_periods=12)
    return {
        "seed": (HIST, dict(seed=2), HIST, dict(seed=1)),
        "months": (HIST, dict(n_periods=13), HIST, {}),
        "histogram": (HIST, dict(options=smt.EngineOptions(
            histogram=False, **CPU)), HIST, {}),
        "rng": (dataclasses.replace(HIST, rng="reference"), {}, HIST, {}),
        "index_offset": (dataclasses.replace(sobol, index_offset=1 << 20),
                         {}, sobol, {}),
    }, opts


@pytest.mark.parametrize("case", ["seed", "months", "histogram", "rng",
                                  "index_offset"])
def test_other_run_refuses(tmp_path, case):
    runs, opts = _other_runs()
    other, other_kw, model, kw = runs[case]
    path = str(tmp_path / "run.npz")
    base = dict(n_paths=TILE, n_periods=12, seed=1, options=opts)
    smt.simulate_stats(model, checkpoint_path=path, **dict(base, **kw))
    with pytest.raises(ValueError, match="different run"):
        smt.simulate_stats(other, checkpoint_path=path,
                           **dict(base, **other_kw))


def test_checkpoint_rejects_keep_finals(tmp_path):
    with pytest.raises(ValueError, match="keep_final_values"):
        smt.simulate_stats(GAUSS, TILE, 4, options=smt.EngineOptions(**CPU),
                           checkpoint_path=str(tmp_path / "c.npz"),
                           keep_final_values=True)


def test_checkpoint_state_roundtrip(tmp_path):
    path = str(tmp_path / "s.npz")
    st = ckpt.CheckpointState(
        fingerprint="ab" * 32, next_offset=12345, paths_done=999,
        stats=np.arange(9, dtype=np.float64),
        hist=np.arange(16, dtype=np.float64),
    )
    ckpt.save(path, st)
    back = ckpt.load(path, "ab" * 32)
    assert (back.fingerprint, back.next_offset, back.paths_done) == (
        "ab" * 32, 12345, 999)
    np.testing.assert_array_equal(back.stats, st.stats)
    np.testing.assert_array_equal(back.hist, st.hist)
    assert [p.name for p in tmp_path.iterdir()] == ["s.npz"]
    assert ckpt.load(str(tmp_path / "missing.npz"), "x") is None


def test_clt_falling_back_to_icdf_shares_the_icdf_fingerprint(tmp_path):
    """A fixed-amount strategy keeps the "clt" option on the ICDF month
    loop, so its checkpoint resumes a run under the default sampler; with
    no withdrawals "clt" runs the CLT and refuses an ICDF checkpoint."""
    n, t = 2 * TILE, 6
    clt = smt.EngineOptions(gaussian_sampler="clt", **CPU)
    icdf = smt.EngineOptions(**CPU)
    strategy = smt.FixedAmountWithdrawal(5.0)
    path = str(tmp_path / "run.npz")
    first = smt.simulate_stats(GAUSS, n, t, seed=1, strategy=strategy,
                               checkpoint_path=path, options=clt)
    again = smt.simulate_stats(GAUSS, n, t, seed=1, strategy=strategy,
                               checkpoint_path=path, options=icdf)
    _assert_identical(again, first)
    plain = str(tmp_path / "plain.npz")
    smt.simulate_stats(GAUSS, n, t, seed=1, checkpoint_path=plain,
                       options=icdf)
    with pytest.raises(ValueError, match="different run"):
        smt.simulate_stats(GAUSS, n, t, seed=1, checkpoint_path=plain,
                           options=clt)


def test_clt_prefix_checkpoint_of_another_finish_refuses(tmp_path,
                                                       monkeypatch):
    """The clt-prefix sampler's stream tag names the kernel's finish order:
    a checkpoint under the tag without it (the column-by-column finish
    before the quad scan) refuses, the same state under the current tag
    resumes; the other samplers' tags carry no such marker."""
    opts = smt.EngineOptions(gaussian_sampler="clt-prefix", **CPU)
    strategy = smt.FixedPercentWithdrawal(0.4)
    n, t = 3 * TILE, 12
    kw = dict(seed=2, target_amount=1100.0, strategy=strategy, options=opts)
    path = str(tmp_path / "prefix.npz")
    seen = []
    real = ckpt.config_fingerprint

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(ckpt, "config_fingerprint", spy)
    _interrupted(GAUSS, n, t, path, 1, **kw)
    assert seen[0][-1] == "torch/streams3/clt-prefix-quadscan"
    state = ckpt.load(path, _fingerprint(path))
    ckpt.save(path, dataclasses.replace(
        state, fingerprint=real(*seen[0][:-1], "torch/streams3/clt-prefix")))
    with pytest.raises(ValueError, match="different run"):
        smt.simulate_stats(GAUSS, n, t, checkpoint_path=path, **kw)
    ckpt.save(path, state)
    resumed = smt.simulate_stats(GAUSS, n, t, checkpoint_path=path, **kw)
    _assert_identical(resumed, smt.simulate_stats(GAUSS, n, t, **kw))
    seen.clear()
    smt.simulate_stats(GAUSS, TILE, t, checkpoint_path=str(
        tmp_path / "nw.npz"), **dict(kw, options=smt.EngineOptions(
            gaussian_sampler="clt-prefix", track_withdrawn=False, **CPU)))
    assert seen[0][-1] == "torch/streams3/clt-nw"


@pytest.mark.parametrize("prng", ["default", "arith"])
def test_jax_checkpoint_refuses(tmp_path, monkeypatch, prng):
    """The JAX package's checkpoint of the same arguments, from its default
    backend or from the arithmetic stream the port draws: its float32
    chunk sums run in another order, so the port refuses to resume it."""
    path = str(tmp_path / "jax.npz")
    opts = JaxOptions(chunk_paths=TILE)
    if prng == "arith":
        monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
        opts = JaxOptions(backend="pallas", chunk_paths=TILE)
    smmc.simulate_stats(smmc.HistoricalBootstrap.from_csv(), TILE, 12,
                        seed=1, options=opts, checkpoint_path=path)
    with pytest.raises(ValueError, match="different run"):
        smt.simulate_stats(HIST, TILE, 12, seed=1,
                           options=smt.EngineOptions(**CPU),
                           checkpoint_path=path)


# ---------------------------------------------------------------------------
# Across topologies (tests/test_checkpoint.py::
# test_checkpoint_cross_topology_resume)
# ---------------------------------------------------------------------------

TOPO_N = 8 * TILE + 777
TOPO_T = 6
TOPO_KW = dict(seed=3, target_amount=1200.0)
MOMENT_REL = 1e-6


def _mesh_run(world, **kw):
    """Each rank's ``test_torch_mesh.checkpointed_run`` (seed 3, target
    1200, as TOPO_KW)."""
    return run_ranks(world, "test_torch_mesh:checkpointed_run",
                     dict(kw, n=TOPO_N, t=TOPO_T), device="cpu",
                     timeout=60.0)


def _single(path=None, chunk=TILE):
    return smt.simulate_stats(
        HIST, TOPO_N, TOPO_T, options=smt.EngineOptions(device="cpu",
                                                        chunk_paths=chunk),
        checkpoint_path=path, **TOPO_KW)


def _assert_resumed(moments, hist, fresh, exact):
    """The resumed run against an uninterrupted one: bit for bit at the
    same chunk size; counts, extrema and cells exact at another, the
    moments within MOMENT_REL."""
    m = fresh.moments
    np.testing.assert_array_equal(hist, fresh.histogram_counts)
    got = dict(zip(("n", "mean", "var", "std", "min", "max", "skew",
                    "kurtosis", "count_below", "total_withdrawn"), moments))
    assert (got["n"], got["min"], got["max"], got["count_below"]) == (
        m.n, m.min, m.max, m.count_below)
    if exact:
        assert (got["mean"], got["var"], got["skew"], got["kurtosis"]) == (
            m.mean, m.var, m.skew, m.kurtosis)
    np.testing.assert_allclose([got["mean"], got["std"]], [m.mean, m.std],
                               rtol=MOMENT_REL)


@pytest.mark.parametrize("chunk", [TILE, 2 * TILE])
def test_mesh_checkpoint_resumes_on_one_device(tmp_path, chunk):
    path = str(tmp_path / "mesh.npz")
    ranks = _mesh_run(2, path=path, chunk=TILE, stop_after=2)
    # one report a dispatch of 2 chunks, on both ranks
    assert [list(r["calls"]) for r in ranks] == [[2 * TILE, 4 * TILE]] * 2
    assert "moments" not in ranks[0]
    resumed = _single(path, chunk)
    fresh = _single()
    _assert_resumed(_moments_of(resumed), resumed.histogram_counts, fresh,
                    exact=chunk == TILE)
    if chunk == TILE:
        _assert_identical(resumed, fresh)


@pytest.mark.parametrize("chunk", [TILE, 2 * TILE])
def test_checkpoint_resumes_on_a_mesh(tmp_path, chunk):
    path = str(tmp_path / "single.npz")
    calls = _interrupted(HIST, TOPO_N, TOPO_T, path, 2,
                         options=smt.EngineOptions(device="cpu",
                                                   chunk_paths=TILE),
                         **TOPO_KW)
    assert calls == [TILE, 2 * TILE]
    ranks = _mesh_run(3, path=path, chunk=chunk)
    fresh = _single()
    for r in ranks:
        # the resumed paths reported first, then a dispatch of 3 chunks
        assert r["calls"][0] == 2 * TILE and r["calls"][-1] == TOPO_N
        _assert_resumed(r["moments"], r["hist"], fresh, exact=chunk == TILE)


def _moments_of(res):
    m = res.moments
    return np.array([m.n, m.mean, m.var, m.std, m.min, m.max, m.skew,
                     m.kurtosis, m.count_below, m.total_withdrawn],
                    np.float64)
