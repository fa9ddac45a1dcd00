"""Seed segments in the port against the JAX package, on the CPU: runs
past ``EngineOptions.seed_segment_paths`` paths partition into segments,
segment s >= 1 drawing under fold_in(key(seed), _SEG_FOLD + s), with no
chunk straddling a boundary (the semantics of tests/test_segments.py).
The segment is shrunk to one 8192-path tile so a few tiles exercise the
boundary, key and merge logic.

The JAX side runs as tests/test_torch_gaussian.py runs it (arithmetic
counter stream, Pallas interpret mode); the port runs its plain versions.
Each sampler meets its bar of the unsegmented tests: the historical month
loop bit for bit, the Gaussian ICDF, the CLT and the terminal law within
their relative bars.
"""

import numpy as np
import pytest

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_tpu.config import EngineOptions as JaxOptions
from stock_market_monte_carlo_tpu.ops import pallas_engine as pe

SEG = 8192
N = 3 * SEG + 777           # four segments, the last ragged
HIST = smmc.HistoricalBootstrap.from_csv()
GAUSS = smmc.GaussianReturns()
# sampler: (model, options, strategy, finals bar); bars of the unsegmented
# parity tests (test_torch_engine.py, test_torch_gaussian.py)
CASES = {
    "historical": (HIST, {}, smmc.FixedPercentWithdrawal(0.4), 0.0),
    "icdf": (GAUSS, {}, smmc.NoWithdrawal(), 1e-6),
    "clt": (GAUSS, dict(gaussian_sampler="clt"), smmc.NoWithdrawal(), 5e-6),
    "law": (HIST, dict(terminal_law=True, track_withdrawn=False),
            smmc.FixedPercentWithdrawal(0.1), 2e-6),
}


def _port(model, n, t, seed, strategy, **opts):
    opts = dict(dict(device="cpu", chunk_paths=8192, seed_segment_paths=SEG),
                **opts)
    return smt.simulate_stats(
        from_reference(model), n, t, seed=seed,
        strategy=from_reference(strategy), target_amount=1000.0,
        keep_final_values=True, options=smt.EngineOptions(**opts))


@pytest.mark.parametrize("sampler", sorted(CASES))
def test_segmented_run_matches_jax(sampler, monkeypatch):
    model, opts, strategy, rel = CASES[sampler]
    monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
    want = smmc.simulate_stats(
        model, N, 12, seed=9, strategy=strategy, target_amount=1000.0,
        keep_final_values=True, options=JaxOptions(
            backend="pallas", chunk_paths=8192, seed_segment_paths=SEG,
            **opts))
    got = _port(model, N, 12, 9, strategy, **opts)
    np.testing.assert_allclose(got.final_values, want.final_values,
                               rtol=rel, atol=0)
    assert got.moments.n == want.moments.n == N
    assert got.histogram_counts.sum() == N
    near = int(np.sum(np.abs(want.final_values / 1000.0 - 1.0) <= rel))
    assert abs(got.moments.count_below - want.moments.count_below) <= near
    assert got.mean == pytest.approx(want.mean, rel=max(rel, 1e-9))


def test_segment_bases_match_jax():
    """The stream base of each segment's key, as the Pallas kernels take
    it from the key data."""
    import jax

    for seed in (0, 9, -3):
        for s in range(4):
            key = jax.random.key(seed)
            if s:
                key = jax.random.fold_in(key, port_engine._SEG_FOLD + s)
            want = int(np.asarray(pe._seed_base_i32(key)).view(np.uint32))
            assert port_engine._segment_base(seed, s) == want


def test_segment_zero_is_the_unsegmented_stream():
    """Segment 0 runs under the plain seed: the first SEG finals equal an
    unsegmented run's; the next segment draws fresh paths."""
    seg = _port(HIST, N, 12, 9, smmc.NoWithdrawal())
    plain = _port(HIST, SEG, 12, 9, smmc.NoWithdrawal(),
                  seed_segment_paths=1 << 31)
    np.testing.assert_array_equal(seg.final_values[:SEG], plain.final_values)
    assert not np.array_equal(seg.final_values[SEG:2 * SEG],
                              seg.final_values[:SEG])


def test_segmented_chunk_invariance():
    """Chunks larger than a segment stop at its boundary: the finals do
    not depend on the chunk size; nor on the deferred absorb."""
    a = _port(GAUSS, N, 12, 4, smmc.NoWithdrawal())
    b = _port(GAUSS, N, 12, 4, smmc.NoWithdrawal(), chunk_paths=2 * 8192)
    np.testing.assert_array_equal(a.final_values, b.final_values)
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)
    deferred = smt.simulate_stats(
        smt.GaussianReturns(), N, 12, seed=4, target_amount=1000.0,
        options=smt.EngineOptions(device="cpu", chunk_paths=8192,
                                  seed_segment_paths=SEG))
    assert deferred.moments == a.moments


def test_segment_headroom_rejection_matches_jax():
    kw = dict(seed_segment_paths=1 << 32)
    with pytest.raises(ValueError, match="headroom") as want:
        smmc.simulate_stats(GAUSS, (1 << 32) + 8192, 1,
                            options=JaxOptions(**kw))
    with pytest.raises(ValueError, match="headroom") as got:
        smt.simulate_stats(smt.GaussianReturns(), (1 << 32) + 8192, 1,
                           options=smt.EngineOptions(device="cpu", **kw))
    assert str(got.value) == str(want.value)
