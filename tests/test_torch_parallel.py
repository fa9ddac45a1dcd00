"""The port's paths mesh (``parallel/mesh.py``), the counterparts of
tests/test_parallel.py: in a 1-rank gloo group in this process, and in a
3-rank gloo group of spawned processes (``parallel/_ranks.py``). Also the
engine's refusals of a mesh that cannot run: an object that is no mesh, a
process outside the mesh's ranks, a device other than the mesh's."""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_cpu_share  # noqa: F401

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.parallel import (
    PathsMesh,
    device_count,
    paths_mesh,
)
from stock_market_monte_carlo_torch.parallel._ranks import run_ranks

TILE = 8192
CPU = smt.EngineOptions(device="cpu", chunk_paths=TILE)
WORLD = 3


@pytest.fixture
def one_rank(tmp_path):
    """A 1-rank gloo group in this process, destroyed after the test."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_paths_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    assert device_count() == 1
    with pytest.raises(RuntimeError, match="init_process_group"):
        paths_mesh(device="cpu")


def test_paths_mesh_single_returns_none(one_rank):
    assert device_count() == 1
    assert paths_mesh(device="cpu") is None
    assert paths_mesh(1, device="cpu") is None


def test_paths_mesh_too_many_raises(one_rank):
    with pytest.raises(ValueError, match="available"):
        paths_mesh(10_000, device="cpu")


@pytest.mark.parametrize("n", [0, -1])
def test_paths_mesh_needs_a_rank(one_rank, n):
    with pytest.raises(ValueError, match=">= 1"):
        paths_mesh(n, device="cpu")


def _mesh(**kw):
    return PathsMesh(**dict(dict(group=None, rank=0, size=2,
                                 device=torch.device("cpu")), **kw))


def _engine_calls(mesh, options=CPU):
    hist = smt.HistoricalBootstrap.from_csv()
    return {
        "simulate_stats": lambda: smt.simulate_stats(
            hist, TILE, 6, options=options, mesh=mesh),
        "simulate_bands": lambda: smt.simulate_bands(
            hist, TILE, 6, options=options, mesh=mesh),
        "rqmc_estimate": lambda: smt.rqmc_estimate(
            smt.SobolGaussianReturns.create(6), TILE, 6, replicates=2,
            options=options, mesh=mesh),
    }


def test_mesh_backend_and_device(one_rank, monkeypatch):
    """A gloo group exchanges the host copies: ``start_gather`` and
    ``start_sum`` leave the tensor as it is and the finishing halves
    stack and sum on the host (the sum in int64), as ``gather`` stacks.
    NCCL runs on the cards only."""
    mesh = _mesh(size=1)
    rows = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    counts = torch.arange(6, dtype=torch.int32)
    assert mesh.start_gather(rows) is rows
    assert mesh.start_sum(counts) is counts
    for got in (mesh.finish_gather(rows), mesh.gather(rows)):
        assert got.device.type == "cpu"
        assert torch.equal(got, rows[None])
    got = mesh.finish_sum(counts)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert torch.equal(got, counts.to(torch.int64))
    import stock_market_monte_carlo_torch.parallel.mesh as mesh_module

    monkeypatch.setattr(mesh_module.dist, "get_backend", lambda g: "nccl")
    with pytest.raises(ValueError, match="NCCL paths mesh runs on the cards"):
        _mesh(size=1).gather(rows)


@pytest.mark.parametrize("call", sorted(_engine_calls(None)))
def test_engine_refuses_what_no_mesh_can_run(call):
    """Before any work: an object that is no PathsMesh, a process outside
    the mesh, a mesh on another device than ``options.device`` (a mesh
    never moves work to another device)."""
    with pytest.raises(TypeError, match="PathsMesh"):
        _engine_calls(object())[call]()
    with pytest.raises(RuntimeError, match="not a rank"):
        _engine_calls(_mesh(rank=-1))[call]()
    with pytest.raises(ValueError, match="runs rank 0 on cuda:0"):
        _engine_calls(_mesh(device=torch.device("cuda", 0)))[call]()


def rank_checks(mesh):
    """A rank's view of test_parallel.py's cases on the full mesh and on
    a 2-rank subgroup of it, on one torch thread."""
    torch.set_num_threads(1)
    out = dict(size=mesh.size, rank=mesh.rank, device_count=device_count(),
               backend=str(dist.get_backend(mesh.group)))
    try:
        paths_mesh(10_000, device="cpu")
    except ValueError as e:
        out["too_many"] = str(e)
    # test_engine_with_helper_mesh
    res = smt.simulate_stats(smt.GaussianReturns(), 8 * TILE, 6, seed=0,
                             options=CPU, mesh=mesh)
    out.update(full_n=res.moments.n, full_mean=res.mean)
    # test_mesh_subset: every rank builds the subgroup; the last is out
    sub = paths_mesh(2, device="cpu")
    out.update(sub_size=sub.size, sub_rank=sub.rank)
    if sub.rank >= 0:
        res = smt.simulate_stats(smt.GaussianReturns(), 8 * TILE, 6, seed=0,
                                 options=CPU, mesh=sub)
        out.update(sub_n=res.moments.n, sub_mean=res.mean)
    else:
        try:
            smt.simulate_stats(smt.GaussianReturns(), 8 * TILE, 6,
                               options=CPU, mesh=sub)
        except RuntimeError as e:
            out["outside"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(WORLD, "test_torch_parallel:rank_checks", device="cpu",
                     timeout=60.0)


def test_paths_mesh_all_devices(ranks):
    for rank, r in enumerate(ranks):
        assert int(r["size"]) == int(r["device_count"]) == WORLD
        assert int(r["rank"]) == rank
        assert str(r["backend"]) == "gloo"
        assert "only 3 available" in str(r["too_many"])


def test_engine_with_helper_mesh(ranks):
    want = smt.simulate_stats(smt.GaussianReturns(), 8 * TILE, 6, seed=0,
                              options=CPU)
    for r in ranks:
        assert int(r["full_n"]) == 8 * TILE
        assert np.isfinite(r["full_mean"])
        assert float(r["full_mean"]) == want.mean


def test_mesh_subset(ranks):
    """paths_mesh(2) of 3 ranks: the first two run it, the third holds a
    mesh that raises when used."""
    assert [int(r["sub_rank"]) for r in ranks] == [0, 1, -1]
    assert all(int(r["sub_size"]) == 2 for r in ranks)
    for r in ranks[:2]:
        assert int(r["sub_n"]) == 8 * TILE
        assert float(r["sub_mean"]) == float(ranks[0]["full_mean"])
    assert "not a rank" in str(ranks[2]["outside"])
