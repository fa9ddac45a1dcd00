"""The port's samplers under a paths mesh on the CPU, modelled on
tests/test_pallas_mesh.py and tests/test_multihost.py: 2-rank and 3-rank
gloo groups of spawned processes (``parallel/_ranks.py``, a ``file://``
store) run every case once per module; every rank must equal every other
rank, and the single-process port run at the same ``chunk_paths``, bit for
bit: the 9 packed sums, the moments, every cell and the finals. At 3 ranks
the shards are uneven and the last dispatch has shards with no valid path.
A run of at most ``chunk_paths * ranks`` paths buckets its shards smaller
than the single-device chunk: there the sums agree within 1e-6 and the
rest exactly. Also the port's mesh runs against the JAX package's mesh
run on the arithmetic stream.

The ranks and the single-process runs use one torch thread each: the
comparison is of the merge, and 5 ranks of the default thread count
beside the other test workers would oversubscribe the cores.
"""

import numpy as np
import pytest
import torch

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.parallel._ranks import run_ranks

TILE = 8192
# a ragged tail whose last dispatch leaves a shard empty at 2 and 3 ranks
N = 4 * TILE + 777
T = 6
TARGET = 1200.0
WORLDS = (2, 3)
RANK_TIMEOUT = 240.0
SUM_REL = 1e-6
# the JAX package's smallest arith-stream mesh case
# (tests/test_pallas_mesh.py::test_arith_historical_sliced_rotation_
# sharded_bitexact): 4 tiles + 777 paths, 5 months, seed 2, target 1200
JAX_N, JAX_T, JAX_SEED = 4 * TILE + 777, 5, 2

MOMENT_FIELDS = ("n", "mean", "var", "std", "min", "max", "skew",
                 "kurtosis", "count_below", "total_withdrawn")


def _opts(device="cpu", **kw):
    return smt.EngineOptions(device=device, **dict(dict(chunk_paths=TILE),
                                                   **kw))


def _moments(m):
    return np.array([np.nan if getattr(m, f) is None else getattr(m, f)
                     for f in MOMENT_FIELDS], np.float64)


def _stats_case(model, n=N, t=T, strategy=smt.NoWithdrawal(), seed=3,
                finals=False, **opts):
    """Every output of a simulate_stats case: deferred (no callback), and
    through a stream callback (the packed sums, the dones it reported)."""
    def run(mesh, device):
        kw = dict(seed=seed, strategy=strategy, target_amount=TARGET,
                  options=_opts(device, **opts), mesh=mesh)
        res = smt.simulate_stats(model(), n, t, keep_final_values=finals,
                                 **kw)
        updates = []
        smt.simulate_stats(model(), n, t, stream=updates.append, **kw)
        out = dict(moments=_moments(res.moments),
                   packed=updates[-1].stats, hist=updates[-1].hist,
                   dones=np.array([u.done for u in updates]))
        if res.histogram_counts is not None:
            out["hist_deferred"] = res.histogram_counts
        if finals:
            out["finals"] = res.final_values
        return out
    return run


def _bands_case(model, mode, strategy=smt.NoWithdrawal()):
    def run(mesh, device):
        kw = (dict(n_bins=64) if mode == "hist"
              else dict(n_thresholds=16))
        res = smt.simulate_bands(model(), N, T, seed=5, strategy=strategy,
                                 sample_paths=4, options=_opts(device),
                                 band_mode=mode, mesh=mesh, **kw)
        return dict(values=res.values, month_hist=res.month_hist,
                    sample_paths=res.sample_paths)
    return run


def _rqmc_case(mesh, device):
    est = smt.rqmc_estimate(smt.SobolGaussianReturns.create(T), N, T,
                            replicates=3, seed=4, options=_opts(device),
                            mesh=mesh)
    return dict(replicate_means=est.replicate_means,
                interval=np.array([est.mean, est.sem, est.ci_lo,
                                   est.ci_hi]))


def _hist():
    return smt.HistoricalBootstrap.from_csv()


def _gauss():
    return smt.GaussianReturns(mean_pct=0.5, std_pct=10.0 / 12)


def _reference():
    return smt.HistoricalBootstrap(_hist().returns_pct, rng="reference")


CASES = {
    "historical": _stats_case(_hist),
    "law": _stats_case(_hist, t=24, terminal_law=True),
    "icdf_fixed_percent": _stats_case(
        _gauss, strategy=smt.FixedPercentWithdrawal(1.0)),
    "clt": _stats_case(_gauss, gaussian_sampler="clt"),
    "sobol_gaussian": _stats_case(lambda: smt.SobolGaussianReturns.create(T)),
    "reference": _stats_case(_reference),
    "segmented": _stats_case(_hist, n=5 * TILE + 777,
                             seed_segment_paths=2 * TILE),
    "keep_final_values": _stats_case(_hist, finals=True),
    "fixed_amount_finals": _stats_case(
        _hist, strategy=smt.FixedAmountWithdrawal(20.0), finals=True),
    "no_histogram": _stats_case(_hist, histogram=False),
    # at most chunk_paths * ranks paths: shards bucketed below the chunk
    "small_run": _stats_case(_hist, n=3 * TILE + 777,
                             chunk_paths=4 * TILE),
    "jax_historical": _stats_case(_hist, n=JAX_N, t=JAX_T, seed=JAX_SEED,
                                  finals=True),
    "bands_hist": _bands_case(_hist, "hist"),
    "bands_cdf": _bands_case(_gauss, "cdf",
                             smt.FixedPercentWithdrawal(0.5)),
    "rqmc": _rqmc_case,
}
# compared with each other rank only: a mesh reports once a dispatch
RANKS_ONLY = ("dones",)
# keys within SUM_REL of the single-device run in the small-run case
SMALL_RUN_SUMS = ("moments", "packed")


def run_cases(mesh, names, device="cpu"):
    """A rank's results on ``device``: ``{case/key: array}``, on one torch
    thread. Also run on the card by tests/test_torch_gpu.py."""
    torch.set_num_threads(1)
    return {f"{name}/{k}": v for name in names
            for k, v in CASES[name](mesh, device).items()}


class _Stop(Exception):
    pass


def checkpointed_run(mesh, path, n, chunk, stop_after=0, t=T, seed=3):
    """A rank's checkpointed historical run: with ``stop_after``, stopped
    by a progress callback that raises on every rank at its
    ``stop_after``-th report (the checkpoint then holds that many
    dispatches); else run to its end (resumed where ``path`` holds a
    checkpoint). On one torch thread, for tests/test_torch_checkpoint.py."""
    torch.set_num_threads(1)
    calls = []

    def progress(done, total):
        calls.append(done)
        if len(calls) == stop_after:
            raise _Stop()

    out = dict(calls=calls)
    try:
        res = smt.simulate_stats(
            _hist(), n, t, seed=seed, target_amount=TARGET,
            options=_opts(chunk_paths=chunk), mesh=mesh,
            checkpoint_path=path, progress=progress)
    except _Stop:
        return out
    return dict(out, moments=_moments(res.moments),
                hist=res.histogram_counts)


def split_cases(flat):
    out = {}
    for key, v in flat.items():
        name, k = key.split("/")
        out.setdefault(name, {})[k] = v
    return out


@pytest.fixture(scope="module")
def ranks():
    """{world: [rank 0's {case: {key: array}}, ...]}, every case run once
    per world; the two worlds start together."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(
            run_ranks, w, "test_torch_mesh:run_cases",
            dict(names=sorted(CASES)), device="cpu", timeout=RANK_TIMEOUT)
            for w in WORLDS}
        return {w: [split_cases(r) for r in f.result()]
                for w, f in futures.items()}


@pytest.fixture(scope="module")
def single():
    """The single-process port run of every case, on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return split_cases(run_cases(None, sorted(CASES)))
    finally:
        torch.set_num_threads(n)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def check_case(case, got, want):
    """Every rank's results ``got`` of ``case`` equal each other's bit for
    bit, and the single-device results ``want`` (but where the mesh
    reports once a dispatch, and the small run's sums). Also used by
    tests/test_torch_gpu.py on the card."""
    for rank, res in enumerate(got[1:], 1):
        assert res.keys() == got[0].keys()
        for k in res:
            assert _same_bits(res[k], got[0][k]), (rank, k)
    assert got[0].keys() == want.keys()
    for k, v in want.items():
        if k in RANKS_ONLY:
            continue
        if case == "small_run" and k in SMALL_RUN_SUMS:
            np.testing.assert_allclose(got[0][k], v, rtol=SUM_REL)
            # n, min, max and the count are exact
            idx = [0, 4, 5, 8] if k == "moments" else [0, 5, 6, 7]
            assert _same_bits(got[0][k][idx], v[idx]), k
            continue
        assert _same_bits(got[0][k], v), k


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_equals_single_device(ranks, single, world, case):
    check_case(case, [r[case] for r in ranks[world]], single[case])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_reports_once_a_dispatch(ranks, world):
    """The stream fires after every dispatch of ``world`` chunks."""
    dones = ranks[world][0]["historical"]["dones"]
    per = world * TILE
    np.testing.assert_array_equal(
        dones, [min(N, per * (i + 1)) for i in range(-(-N // per))])


def test_mesh_matches_the_jax_package(ranks, monkeypatch, mesh8):
    """The port's 2- and 3-rank mesh runs against the JAX package's 8-device
    mesh run on the arithmetic stream, at the shape of its smallest mesh
    case, to its ``_stats_identical`` bars but the histogram, whose cells
    may move by one where XLA's and torch's CPU logs differ in the last bit
    at a bin edge (tests/test_torch_engine.py), and the finals bit for
    bit."""
    import stock_market_monte_carlo_tpu as smmc
    from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOpts

    monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
    kw = dict(seed=JAX_SEED, options=JaxOpts(backend="pallas",
                                            chunk_paths=TILE), mesh=mesh8)
    want = smmc.simulate_stats(smmc.HistoricalBootstrap.from_csv(), JAX_N,
                               JAX_T, target_amount=TARGET, **kw)
    finals = smmc.simulate_final_values(smmc.HistoricalBootstrap.from_csv(),
                                        JAX_N, JAX_T, **kw)
    m = want.moments
    for world in WORLDS:
        got = ranks[world][0]["jax_historical"]
        moments = dict(zip(MOMENT_FIELDS, got["moments"]))
        np.testing.assert_allclose(moments["mean"], m.mean, rtol=1e-6)
        np.testing.assert_allclose(moments["std"], m.std, rtol=1e-6,
                                   atol=1e-6)
        assert moments["n"] == m.n
        assert moments["min"] == m.min and moments["max"] == m.max
        assert moments["count_below"] == m.count_below
        hist = got["hist_deferred"]
        assert hist.sum() == want.histogram_counts.sum() == JAX_N
        assert np.abs(hist - want.histogram_counts).max() <= 2
        np.testing.assert_array_equal(got["finals"], np.asarray(finals))
