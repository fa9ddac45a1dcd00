"""The port's threefry functions against jax, and its trajectories
(``simulate_paths``, ``run(keep_trajectories=...)``) against the JAX
package, on the CPU.

Keys, ``fold_in``, ``split``, bits, uniform and randint are bit for bit.
``normal`` goes through the erfinv polynomial, whose steps XLA contracts
into fmas on the CPU: at most a few ulp apart. Trajectories are held to
relative bars: a Gaussian growth inherits the normal's ulp, a fixed amount
is withdrawn with an fma by XLA (``total * g - amount``), and XLA's
cumulative product associates in another order than torch's sequential
one; the differences compound over the horizon. A fixed-amount path
depleting towards 0 loses its relative digits, so those cases add an
absolute bar in units of the initial capital.
"""

import jax
import numpy as np
import pytest
import torch

import stock_market_monte_carlo_torch as smt
import stock_market_monte_carlo_tpu as smmc
from stock_market_monte_carlo_torch.engine import engine as port_engine
from stock_market_monte_carlo_torch.models.convert import from_reference
from stock_market_monte_carlo_torch.ops import threefry as tf
from stock_market_monte_carlo_tpu.engine import engine as jax_engine
from test_torch_engine import CPU, STRATEGY_NAMES, _strategy

SEEDS = (0, 12345, 2**31 - 1, -1, -7)
# normal: measured 2.4e-7 (2 ulp) at most over 8192 x 7 draws per seed
NORMAL_REL = 5e-7
# trajectories by horizon; measured 9.6e-7 at 12 months, 1.1e-5 at 360
TRAJ_REL = {12: 2e-6, 360: 3e-5}
# fixed amount near depletion: measured 0.0137 abs at 360 months of v0=1000
TRAJ_ABS_FIXED_AMOUNT = 2e-5
# one bfloat16 ulp
BF16_REL = 2.0**-7
MODELS = {"gaussian": smmc.GaussianReturns(),
          "historical": smmc.HistoricalBootstrap.from_csv()}


def _kd(key):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_match_jax(seed):
    key, jkey = tf.key(seed), jax.random.key(seed)
    assert tf.key_data(key) == _kd(jkey)
    for data in (0, 1, 5, 0x50B0, jax_engine._SEG_FOLD + 1,
                 jax_engine._SEG_FOLD + 3, 2**32 - 1):
        assert tf.key_data(tf.fold_in(key, data)) == _kd(
            jax.random.fold_in(jkey, data)), data
    # tile keys, one call for a batch of tiles as sample_growth draws them
    tiles = list(range(1000, 1006)) + [2**32 - 1]
    k0, k1 = tf.fold_in(key, torch.tensor(tiles))
    for j, tile in enumerate(tiles):
        assert (int(k0[j]), int(k1[j])) == _kd(jax.random.fold_in(jkey,
                                                                  tile))
    s0, s1 = tf.split(key, 3)
    np.testing.assert_array_equal(
        torch.stack([s0, s1], 1).numpy(),
        np.asarray(jax.random.key_data(jax.random.split(jkey, 3)),
                   np.int64))
    assert port_engine._SEG_FOLD == jax_engine._SEG_FOLD


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(8192, 7), (3, 5, 2), (1,)])
def test_bits_uniform_normal_match_jax(seed, shape):
    key, jkey = tf.key(seed), jax.random.key(seed)
    np.testing.assert_array_equal(
        tf.bits(key, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jkey, shape)))
    np.testing.assert_array_equal(tf.uniform(key, shape).numpy(),
                                  np.asarray(jax.random.uniform(jkey, shape)))
    got = tf.normal(key, shape).numpy()
    want = np.asarray(jax.random.normal(jkey, shape))
    np.testing.assert_allclose(got, want, rtol=NORMAL_REL, atol=0)
    if got.size > 100:
        assert np.mean(got == want) > 0.9


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [97, 1127])
def test_randint_matches_jax(seed, n):
    key, jkey = tf.key(seed), jax.random.key(seed)
    np.testing.assert_array_equal(
        tf.randint(key, (8192, 12), 0, n).numpy(),
        np.asarray(jax.random.randint(jkey, (8192, 12), 0, n)))
    # a batch of tile keys draws what each key draws alone
    tiles = torch.arange(7, 10)
    got = tf.randint(tf.fold_in(key, tiles), (64, 3), 0, n).numpy()
    for j in range(3):
        np.testing.assert_array_equal(got[j], np.asarray(
            jax.random.randint(jax.random.fold_in(jkey, 7 + j), (64, 3), 0,
                               n)))


def test_sample_returns_match_jax():
    """Each model's ``sample_returns_pct`` under one key: the historical
    lookup bit for bit, the Gaussian within the normal's bar."""
    key, jkey = tf.key(4), jax.random.key(4)
    for name, model in MODELS.items():
        got = from_reference(model).sample_returns_pct(key, (256, 9))
        want = np.asarray(model.sample_returns_pct(jkey, (256, 9)))
        if name == "historical":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


def _assert_traj_close(got, want, t, name, v0=1000.0, rel=None):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    atol = TRAJ_ABS_FIXED_AMOUNT * v0 if name == "fixed_amount" else 0.0
    np.testing.assert_allclose(got, want, rtol=rel or TRAJ_REL[t],
                               atol=atol)


def _paths_both(kind, name, n, t, **kw):
    model, strategy = MODELS[kind], _strategy(name)
    want = smmc.simulate_paths(model, n, t, seed=3, strategy=strategy, **kw)
    got = smt.simulate_paths(from_reference(model), n, t, seed=3,
                             strategy=from_reference(strategy),
                             options=smt.EngineOptions(**CPU), **kw)
    return got, want


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_simulate_paths_matches_jax(kind, name):
    got, want = _paths_both(kind, name, 300, 12)
    _assert_traj_close(got, want, 12, name)


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("name", ["none", "fixed_amount"])
def test_simulate_paths_long_horizon_matches_jax(kind, name):
    got, want = _paths_both(kind, name, 64, 360)
    _assert_traj_close(got, want, 360, name)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_simulate_paths_unaligned_offset(kind):
    """Any path_offset returns exactly those rows of the stream: the window
    aligns down to the tile and drops the lead rows (here across a tile
    boundary)."""
    got, want = _paths_both(kind, "fixed_percent", 300, 12, path_offset=8000)
    _assert_traj_close(got, want, 12, "fixed_percent")
    model = from_reference(MODELS[kind])
    strategy = from_reference(_strategy("fixed_percent"))
    whole = smt.simulate_paths(model, 8300, 12, seed=3, strategy=strategy,
                               options=smt.EngineOptions(**CPU))
    np.testing.assert_array_equal(got, whole[8000:])


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_simulate_paths_bfloat16_matches_jax(kind):
    got, want = _paths_both(kind, "none", 200, 12, dtype="bfloat16")
    _assert_traj_close(got, want, 12, "none", rel=BF16_REL)
    f32, _ = _paths_both(kind, "none", 200, 12)
    np.testing.assert_array_equal(
        got, torch.as_tensor(f32).to(torch.bfloat16).float().numpy())


def test_simulate_paths_rejections_match_jax():
    model = smmc.GaussianReturns()
    for args, kw in (((model, 10**9, 360), {}),
                     ((model, 10, 12), dict(dtype="float16"))):
        with pytest.raises(ValueError) as want:
            smmc.simulate_paths(*args, **kw)
        with pytest.raises(ValueError) as got:
            smt.simulate_paths(from_reference(args[0]), *args[1:],
                               options=smt.EngineOptions(**CPU), **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_keep_trajectories_matches_jax(dtype, monkeypatch):
    monkeypatch.setenv("SMMC_PRNG_IMPL", "arith")
    model, strategy = MODELS["historical"], _strategy("fixed_percent")
    want = smmc.run(model, 8192 + 5, 12, seed=6, strategy=strategy,
                    keep_trajectories=7, options=smmc.EngineOptions(
                        backend="pallas", chunk_paths=8192,
                        trajectory_dtype=dtype))
    got = smt.run(from_reference(model), 8192 + 5, 12, seed=6,
                  strategy=from_reference(strategy), keep_trajectories=7,
                  options=smt.EngineOptions(trajectory_dtype=dtype, **CPU))
    _assert_traj_close(got.trajectories, want.trajectories, 12,
                       "fixed_percent",
                       rel=BF16_REL if dtype == "bfloat16" else None)
    assert got.moments == smt.simulate_stats(
        from_reference(model), 8192 + 5, 12, seed=6,
        strategy=from_reference(strategy),
        options=smt.EngineOptions(**CPU)).moments
    # capped at n_paths
    small = smt.run(from_reference(model), 5, 12, keep_trajectories=9,
                    options=smt.EngineOptions(**CPU))
    assert small.trajectories.shape == (5, 13)


def test_run_checks_trajectories_before_its_stats_run(monkeypatch):
    """A trajectory request that simulate_paths refuses fails before run()
    starts its stats run."""
    from stock_market_monte_carlo_torch.engine import engine as port_engine

    def no_stats(*args, **kwargs):
        raise AssertionError("the stats run started")

    monkeypatch.setattr(port_engine, "simulate_stats", no_stats)
    model = from_reference(smmc.GaussianReturns())
    with pytest.raises(ValueError, match="GiB of trajectories"):
        smt.run(model, 10**9, 360, keep_trajectories=10**9,
                options=smt.EngineOptions(**CPU))
    options = smt.EngineOptions(**CPU)
    object.__setattr__(options, "trajectory_dtype", "bf16")
    with pytest.raises(ValueError, match="dtype must be"):
        smt.run(model, 100, 12, keep_trajectories=3, options=options)
