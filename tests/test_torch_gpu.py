"""The CUDA kernels against their plain PyTorch versions on the card, at
shapes the smoke test does not reach: ragged chunks at a nonzero tile
offset, the hostile 97-row table, a 20000-row table (whose shared-memory
table needs the opt-in above 48 KB), odd histogram sizes and no
histogram; the Gaussian month loop under every strategy; the CLT kernel's
three variants over one and two 128-month blocks; the two band kernels
under both draws and every percent strategy, odd bin and threshold
counts, one and two months. The terminal law's two instances at a
partial tile, under a warp of paths, across the tiles' wrap past 2^32 and
at 1024 blocks, its chunks back to back on two streams, and its
operand-length guard. The historical month loop's warp items at
partial items and three grids, the CLT at three grids, and the CLT's
finish against its CPU twin (``clt.finals_twin``) bit for bit. Also the
wrappers' input checks and launch counters, the launch counts of the
engine's samplers, and bands,
trajectories and seed segments on the card against the CPU. The month
loop's Sobol and reference-parity draws against their plain versions under
every strategy, at 64-bit positions (past 2^33, across a word carry, near
2^62, at offsets of every residue mod 8), with valid paths that leave part
of a Sobol thread's run over, across the 32-bit ids' wrap, at 360 months
and with large tables; the Sobol kernel's windows of direction rows at
360 months under every strategy; the engine, trajectories,
bands and RQMC of those models on the card against the CPU. The
headline's calibration kernels (grid overhead, the calibration pair) and
the counts below a tile against their plain versions, their launch
counters, the calibration kernels' SASS count and the headline's
device-time block. The histogram kernel's three modes and the tile
flatten against their plain versions (past shared memory too), the
engine's large and odd histograms on all three samplers against the CPU,
the Sobol draws at 1866 months with 64-bit positions, and the counted
wrappers queueing chunks without a host synchronisation. The experiment
probes: the op-class toys, the CLT's ablation and tile-grouping instances
and the counter stream's byte planes against their plain versions, their
launch counters and the toys' SASS. The long runs: every bare launcher
holding its outputs after its outputs closure is dropped (ROADMAP queue
3, F4), a checkpoint written on the CPU resumed on the card, and the
stats loop waiting for one chunk at a time under a progress callback and
a checkpoint. The paths mesh on the card: a 1-rank NCCL mesh in this
process and a 2-rank gloo mesh of two child processes sharing the card,
every case of tests/test_torch_mesh.py equal to the single-device run bit
for bit; an NCCL mesh on the CPU and a mesh on another device than
``options.device`` refuse. The user surfaces: the CLI's
``benchmark-mc-gpu`` and ``benchmark-mc-reduceblock --terminal-law`` equal
to direct runs, and the native library built with g++ equal to the
Python reader.

Skipped without a CUDA device. On the card (no jax there, so without the
repository's conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import stock_market_monte_carlo_torch as smt
from stock_market_monte_carlo_torch.bench import held_outputs
from stock_market_monte_carlo_torch.data.loader import (
    HOSTILE_CSV,
    SYNTHETIC_CSV,
    read_historical_returns,
)
from stock_market_monte_carlo_torch.ops import clt
from stock_market_monte_carlo_torch.ops import cuda_engine as ce

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(name):
    if name == "n1127":
        return read_historical_returns(SYNTHETIC_CSV)
    if name == "hostile_n97":
        return read_historical_returns(HOSTILE_CSV)
    # "n20000", "n32000": that many uniform returns
    return np.random.default_rng(3).uniform(-6.0, 6.5, int(name[1:])).astype(
        np.float32)


def _month_kw(strategy, n_table, n_periods, hb, with_hist):
    return dict(n_table=n_table, strategy=strategy, amount=4.0,
                n_periods=n_periods, seed_base=0x9E3779B9, tile0=37,
                valid=2 * 8192 + 1001, n_paths=4 * 8192, v0=1000.0,
                target=990.0, shift=1.01, lo=300.0,
                log_lo=float(np.log(300.0)),
                inv_w=float(np.float32((hb - 2) / np.log(10.0))), hb=hb,
                with_hist=with_hist, keep_finals=True)


def _assert_kernel_matches_plain(k_out, p_out, finals_rel=0.0):
    torch.cuda.synchronize()
    sk, sp = k_out[0].cpu().numpy(), p_out[0].cpu().numpy()
    np.testing.assert_array_equal(sk[[0, 5, 6, 7]], sp[[0, 5, 6, 7]])
    np.testing.assert_allclose(sk[[1, 2, 3, 4, 8]], sp[[1, 2, 3, 4, 8]],
                               rtol=1e-6, atol=1e-6 * np.abs(sp[2]))
    hk, hp = k_out[1].cpu().numpy(), p_out[1].cpu().numpy()
    assert hk.sum() == hp.sum()
    assert np.abs(hk - hp).max() <= 2
    np.testing.assert_allclose(k_out[2].cpu().numpy(),
                               p_out[2].cpu().numpy(), rtol=finals_rel,
                               atol=0)


@pytest.mark.parametrize("table_name", ["n1127", "hostile_n97", "n20000"])
@pytest.mark.parametrize("strategy", ["none", "fixed_percent",
                                      "fixed_amount"])
@pytest.mark.parametrize("hb,with_hist", [(4096, True), (102, True),
                                          (4096, False)])
def test_month_loop_kernel_matches_plain(cuda, table_name, strategy, hb,
                                         with_hist):
    flat, n = ce._pad_table(_table(table_name))
    table = torch.as_tensor(flat, device=cuda)
    keep = torch.full((24,), 0.995, dtype=torch.float32, device=cuda)
    kw = _month_kw(strategy, n, 24, hb, with_hist)
    _assert_kernel_matches_plain(ce.month_loop_chunk(table, keep, **kw),
                                 ce.month_loop_chunk_plain(table, keep, **kw))


# terminal-law chunks: (valid, n_paths, tile0) of a partial last tile, of
# fewer paths than a warp, of tiles that wrap past 2^32, and of a grid of
# 1024 blocks (the finish's rows several batches a lane)
LAW_CASES = {"partial_tile": (3 * 8192 + 17, 4 * 8192, 5),
             "under_a_warp": (19, 4 * 8192, 5),
             "wrap": (3 * 8192 + 17, 4 * 8192, (1 << 32) - 2),
             "many_blocks": ((1 << 20) - 5, 1 << 20, 7)}


def _law_args(cuda, valid=3 * 8192 + 17, n_paths=4 * 8192, tile0=5,
              hb=4096, with_hist=True, keep_finals=True):
    """(law,), kwargs of one terminal-law chunk."""
    from stock_market_monte_carlo_torch.ops.terminal_law import (
        LAW_ZMAX,
        fit_terminal_law,
    )

    op = fit_terminal_law(smt.GaussianReturns(), smt.NoWithdrawal(), 120,
                          1000.0).operand()
    kw = dict(seed_base=0x80000001, tile0=tile0, valid=valid,
              n_paths=n_paths, v0=1000.0, target=1500.0, shift=1.8,
              inv_zmax=1.0 / LAW_ZMAX, lo=200.0,
              log_lo=float(np.log(200.0)),
              inv_w=float(np.float32((hb - 2) / np.log(80.0))), hb=hb,
              with_hist=with_hist, keep_finals=keep_finals, law_host=op)
    return (torch.as_tensor(op, device=cuda),), kw


def _assert_law_matches_plain(k_out, p_out):
    """The law kernel against its plain version: path count, count below,
    min, max and finals bit for bit, the withdrawn row 0; power sums
    within 1e-6 (float64 sums in another order); histogram mass exact,
    cells within 2."""
    torch.cuda.synchronize()
    sk, sp = k_out[0].cpu().numpy(), p_out[0].cpu().numpy()
    np.testing.assert_array_equal(sk[[0, 5, 6, 7, 8]], sp[[0, 5, 6, 7, 8]])
    assert sk[8] == 0.0
    np.testing.assert_allclose(sk[1:5], sp[1:5], rtol=1e-6,
                               atol=1e-6 * np.abs(sp[2]))
    hk, hp = k_out[1].cpu().numpy(), p_out[1].cpu().numpy()
    assert hk.sum() == hp.sum()
    assert np.abs(hk - hp).max() <= 2
    if k_out[2] is not None:
        assert torch.equal(k_out[2], p_out[2])


@pytest.mark.parametrize("case", sorted(LAW_CASES))
@pytest.mark.parametrize("keep_finals", [True, False])
@pytest.mark.parametrize("hb,with_hist", [(4096, True), (128, True),
                                          (102, True), (4160, True),
                                          (4096, False)])
def test_law_kernel_matches_plain(cuda, case, keep_finals, hb, with_hist):
    """Both instances (with and without finals) at a partial last tile,
    under a warp of paths, across the tiles' wrap past 2^32 and at 1024
    blocks, binned in place (4096 cells, the limit, and 128) and by the
    histogram kernel (102 and 4160 cells: the spec route), and without a
    histogram."""
    ops, kw = _law_args(cuda, *LAW_CASES[case], hb, with_hist)
    p_out = ce.law_chunk_plain(*ops, **kw)
    k_out = ce.law_chunk(*ops, **dict(kw, keep_finals=keep_finals))
    assert (k_out[2] is None) == (not keep_finals)
    if not with_hist:
        assert not k_out[1].any()
    _assert_law_matches_plain(k_out, p_out)


def test_law_chunks_back_to_back(cuda):
    """Chunks queued back to back, on the default stream and on a side
    stream at once, each equal bit for bit to the same chunk launched
    alone (the launch's own ticket and cells); a bare launch repeated on
    its buffers gives the same outputs (the kernel leaves them zero)."""
    cases = [_law_args(cuda, *case, hb) for case in LAW_CASES.values()
             for hb in (4096, 128)]
    alone = []
    for ops, kw in cases:
        out = ce.law_chunk(*ops, **kw)
        torch.cuda.synchronize()
        alone.append([t.clone() for t in out])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    queued = [ce.law_chunk(*ops, **kw) for ops, kw in cases]
    with torch.cuda.stream(side):
        queued_side = [ce.law_chunk(*ops, **kw) for ops, kw in cases]
    torch.cuda.synchronize()
    for want, got, got_side in zip(alone, queued, queued_side):
        for a, b, c in zip(want, got, got_side):
            assert torch.equal(a, b) and torch.equal(a, c)
    ops, kw = cases[0]
    launch, outputs = ce.law_launcher(*ops, **kw)
    launch()
    first = [t.clone() for t in outputs()]
    launch()
    for a, b in zip(first, outputs()):
        assert torch.equal(a, b)
    for a, b in zip(first, alone[0]):
        assert torch.equal(a, b)


def test_law_operand_length_refused_before_launch(cuda):
    """An operand of another length than LAW_OP_LEN, a host copy of
    another length, or none, raise before any launch."""
    ops, kw = _law_args(cuda)
    ce.reset_launch_counts()
    with pytest.raises(ValueError, match="49"):
        ce.law_chunk(ops[0][:48], **dict(kw, law_host=kw["law_host"][:48]))
    with pytest.raises(ValueError, match="49"):
        ce.law_chunk(torch.cat([ops[0], ops[0][:1]]), **kw)
    with pytest.raises(ValueError, match="law_host"):
        ce.law_chunk(*ops, **dict(kw, law_host=kw["law_host"][:48]))
    with pytest.raises(ValueError, match="law_host"):
        ce.law_chunk(*ops, **dict(kw, law_host=None))
    assert ce.LAUNCHES["law"] == 0
    ce.law_chunk(*ops, **kw)
    assert ce.LAUNCHES["law"] == 1


@pytest.mark.parametrize("strategy", ["none", "fixed_percent",
                                      "variable_percent", "fixed_amount"])
@pytest.mark.parametrize("hb,with_hist", [(4096, True), (102, True),
                                          (4096, False)])
def test_gaussian_month_loop_kernel_matches_plain(cuda, strategy, hb,
                                                  with_hist):
    keep = torch.as_tensor(np.random.default_rng(5).uniform(
        0.99, 1.0, 24).astype(np.float32), device=cuda)
    a, b = ce.gaussian_ab(0.5, 10.0 / 12)
    kw = dict(_month_kw(strategy, 0, 24, hb, with_hist), draw="gaussian",
              a=a, b=b, shift=1.05)
    _assert_kernel_matches_plain(ce.month_loop_chunk(None, keep, **kw),
                                 ce.month_loop_chunk_plain(None, keep, **kw))


@pytest.mark.parametrize("strategy", ["none", "fixed_percent",
                                      "fixed_amount"])
@pytest.mark.parametrize("extra", range(1, 16))
@pytest.mark.parametrize("keep_finals", [True, False])
def test_gaussian_month_loop_ragged_runs_match_plain(cuda, strategy, extra,
                                                     keep_finals):
    """The run kernel's Gaussian ICDF draw holds K consecutive paths a
    thread (a constant of the draw, at most 16): chunks whose valid paths
    leave 1 .. 15 past a multiple of 16, so 1 .. K-1 past a run's start,
    with and without finals, under each strategy."""
    keep = torch.as_tensor(np.random.default_rng(5).uniform(
        0.99, 1.0, 24).astype(np.float32), device=cuda)
    a, b = ce.gaussian_ab(0.5, 10.0 / 12)
    kw = dict(_month_kw(strategy, 0, 24, 4096, True), draw="gaussian",
              a=a, b=b, shift=1.05, valid=2 * 8192 + 1008 + extra)
    k_out = ce.month_loop_chunk(None, keep, **dict(kw,
                                                   keep_finals=keep_finals))
    p_out = ce.month_loop_chunk_plain(None, keep, **kw)
    if not keep_finals:
        assert k_out[2] is None
        k_out = (k_out[0], k_out[1], p_out[2])
    _assert_kernel_matches_plain(k_out, p_out)
    assert torch.equal(k_out[1], p_out[1])


def _clt_operands(cuda, variant, n_periods, mean=0.5, std=10.0 / 12):
    a, b = ce.gaussian_ab(mean, std)
    keep = np.random.default_rng(6).uniform(0.995, 1.0, n_periods).astype(
        np.float32)
    arow, cs = clt.block_consts(a, b, n_periods,
                                keep if variant == "keep_fold" else None)
    return (clt.q_tensor(cuda), torch.as_tensor(arow, device=cuda),
            torch.as_tensor(cs, device=cuda),
            torch.as_tensor(clt.keep_rows(keep, n_periods), device=cuda)
            if variant == "prefix" else None)


# tensor-core accumulation order against torch.matmul's; chip_smoke.py
# prints the measured maximum
CLT_KERNEL_REL = 1e-5


@pytest.mark.parametrize("variant", ["plain", "keep_fold", "prefix"])
@pytest.mark.parametrize("n_periods", [7, 200])
@pytest.mark.parametrize("hb", [4096, 102])
def test_clt_kernel_matches_plain(cuda, variant, n_periods, hb):
    ops = _clt_operands(cuda, variant, n_periods)
    kw = dict(variant=variant, seed_base=0x9E3779B9 ^ clt.CLT_STREAM_XOR,
              tile0=37, valid=2 * 8192 + 1001, n_paths=4 * 8192, v0=1000.0,
              target=1000.0, shift=1.01, lo=300.0,
              log_lo=float(np.log(300.0)),
              inv_w=float(np.float32((hb - 2) / np.log(10.0))), hb=hb,
              with_hist=True, keep_finals=True)
    sk, hk, fk = clt.clt_chunk(*ops, **kw)
    sp, hp, fp = clt.clt_chunk_plain(*ops, **kw)
    torch.cuda.synchronize()
    fk, fp = fk.cpu().numpy(), fp.cpu().numpy()
    np.testing.assert_allclose(fk, fp, rtol=CLT_KERNEL_REL, atol=0)
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    assert sk[0] == sp[0]
    # a final within the bar of the target may fall on either side
    near = np.sum(np.abs(fp / 1000.0 - 1.0) <= CLT_KERNEL_REL)
    assert abs(sk[7] - sp[7]) <= near
    np.testing.assert_allclose(sk[[5, 6]], sp[[5, 6]], rtol=CLT_KERNEL_REL)
    np.testing.assert_allclose(sk[[1, 2, 8]], sp[[1, 2, 8]], rtol=1e-5,
                               atol=1e-5 * np.abs(sp[2]))
    hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
    assert hk.sum() == hp.sum() == sk[0]
    assert np.abs(hk - hp).sum() <= 2 * np.sum(fk != fp)


def test_clt_kernel_without_finals_or_histogram(cuda):
    ops = _clt_operands(cuda, "plain", 360)
    kw = dict(variant="plain", seed_base=0x11C7, tile0=0, valid=8192 + 5,
              n_paths=2 * 8192, v0=1000.0, target=5000.0, shift=6.0,
              lo=100.0, log_lo=float(np.log(100.0)),
              inv_w=float(np.float32(4094 / np.log(1e3))), hb=4096,
              with_hist=True, keep_finals=True)
    sk, hk, _ = clt.clt_chunk(*ops, **dict(kw, keep_finals=False,
                                            with_hist=False))
    sf, hf, ff = clt.clt_chunk(*ops, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(sk.cpu().numpy(), sf.cpu().numpy())
    assert float(hk.sum()) == 0.0 and float(hf.sum()) == 8192 + 5
    assert ff.shape == (8192 + 5,)


@pytest.mark.parametrize("table_name", ["n1127", "hostile_n97", "n20000"])
@pytest.mark.parametrize("strategy", ["none", "fixed_percent",
                                      "fixed_amount"])
@pytest.mark.parametrize("valid", [1, 255, 257, 2 * 8192 + 1001])
@pytest.mark.parametrize("blocks_per_sm", [4, 8, 16])
def test_month_loop_partial_items_match_plain(cuda, table_name, strategy,
                                              valid, blocks_per_sm):
    """The historical kernel's warps take items of 256 paths: chunks whose
    valid paths end inside an item (one path, one short of a row, one past
    a row, a ragged third tile) at tile0 37, at 4, 8 and 16 blocks a SM."""
    flat, n = ce._pad_table(_table(table_name))
    table = torch.as_tensor(flat, device=cuda)
    keep = torch.full((24,), 0.995, dtype=torch.float32, device=cuda)
    kw = dict(_month_kw(strategy, n, 24, 4096, True), valid=valid)
    launch, outputs = ce.month_loop_launcher(table, keep, **kw,
                                             blocks_per_sm=blocks_per_sm)
    launch()
    _assert_kernel_matches_plain(outputs(),
                                 ce.month_loop_chunk_plain(table, keep, **kw))


@pytest.mark.parametrize("table_name", ["n1127", "hostile_n97", "n20000"])
@pytest.mark.parametrize("valid", [1, 255, 257, 2 * 8192 + 1001])
def test_month_loop_partial_items_spec_histogram(cuda, table_name, valid):
    """The same chunks with 102 cells: the kernel writes the finals and the
    histogram kernel counts them."""
    flat, n = ce._pad_table(_table(table_name))
    table = torch.as_tensor(flat, device=cuda)
    keep = torch.full((24,), 0.995, dtype=torch.float32, device=cuda)
    kw = dict(_month_kw("fixed_percent", n, 24, 102, True), valid=valid)
    _assert_kernel_matches_plain(ce.month_loop_chunk(table, keep, **kw),
                                 ce.month_loop_chunk_plain(table, keep, **kw))


@pytest.mark.parametrize("variant", ["plain", "keep_fold", "prefix"])
def test_clt_grid_does_not_change_results(cuda, variant):
    """At 2, 3 and 4 blocks a SM (the blocks stride over 64-path groups):
    the same finals, counts, min, max and histogram; power sums within
    float64 regrouping."""
    ops = _clt_operands(cuda, variant, 200)
    kw = dict(variant=variant, seed_base=0x9E3779B9 ^ clt.CLT_STREAM_XOR,
              tile0=37, valid=40 * 8192 + 1001, n_paths=41 * 8192,
              v0=1000.0, target=1000.0, shift=1.01, lo=300.0,
              log_lo=float(np.log(300.0)),
              inv_w=float(np.float32(4094 / np.log(10.0))), hb=4096,
              with_hist=True, keep_finals=True)
    outs = []
    for bps in (2, 3, 4):
        launch, outputs = clt.clt_launcher(*ops, **kw, blocks_per_sm=bps)
        launch()
        outs.append(outputs())
    torch.cuda.synchronize()
    s0, h0, f0 = outs[0]
    for s, h, f in outs[1:]:
        assert torch.equal(f, f0) and torch.equal(h, h0)
        assert torch.equal(s[[0, 5, 6, 7]], s0[[0, 5, 6, 7]])
        np.testing.assert_allclose(s.cpu().numpy(), s0.cpu().numpy(),
                                   rtol=1e-6)


def _adversarial_arow(cuda, n_periods):
    """(nblocks, 128) growth constants whose per-column products over the
    blocks spread from near 0 (1e-6) to large (8), with cs = 0: every
    path's row of products is then exact, the same on the card as in
    torch, whatever the product's accumulation order."""
    nblocks = -(-n_periods // clt.CLT_K)
    rng = np.random.default_rng(11)
    logs = rng.normal(0.015, 0.08, clt.CLT_K)
    cols = rng.permutation(clt.CLT_K)
    logs[cols[:3]] = -13.8
    logs[cols[3:6]] = 2.08
    per_block = np.exp(logs / nblocks).astype(np.float32)
    arow = np.broadcast_to(per_block, (nblocks, clt.CLT_K)).copy()
    return (torch.as_tensor(arow, device=cuda),
            torch.zeros((nblocks, clt.CLT_K), dtype=torch.float32,
                        device=cuda))


@pytest.mark.parametrize("variant", ["plain", "keep_fold"])
def test_clt_finish_equals_its_twin(cuda, variant):
    """The kernel's finish against ``clt.finals_twin`` (its sum order, on
    the card's log and exp), bit for bit, at rows of products that do not
    depend on the product's accumulation order (cs = 0)."""
    arow, cs = _adversarial_arow(cuda, 360)
    q = clt.q_tensor(cuda)
    kw = dict(variant=variant, seed_base=0x11C7, tile0=3,
              valid=8192 + 77, n_paths=2 * 8192, v0=1000.0, target=1000.0,
              shift=1.0, lo=1e-30, log_lo=float(np.log(1e-30)),
              inv_w=float(np.float32(4094 / np.log(1e40))), hb=4096,
              with_hist=True, keep_finals=True)
    _, _, fk = clt.clt_chunk(q, arow, cs, None, **kw)
    prod = clt.row_products(q, arow, cs, seed_base=0x11C7, tile0=3,
                            rows=torch.arange(8192 + 77, device=cuda))
    twin = clt.finals_twin(prod, 1000.0)
    torch.cuda.synchronize()
    assert torch.equal(fk, twin)


@pytest.mark.parametrize("ablate", ["nomm", "nologexp"])
def test_clt_probe_finish_equals_its_twin(cuda, ablate):
    """The probes whose products are exact on both sides (nomm: no mixing
    product) or whose finish takes no log (nologexp, against the plain
    version's products at the bar) against the twin: nomm bit for bit on
    the stream's rows, nologexp within the kernel-against-plain bar."""
    ops = _clt_operands(cuda, "plain", 360)[:3]
    kw = dict(seed_base=0x9E3779B9 ^ clt.CLT_STREAM_XOR, tile0=37,
              valid=2 * 8192 + 1001, n_paths=3 * 8192, v0=1000.0,
              target=1000.0, lo=300.0, log_lo=float(np.log(300.0)),
              inv_w=float(np.float32(4094 / np.log(10.0))), hb=4096,
              with_hist=True, keep_finals=True)
    _, _, fk = clt.clt_probe_chunk(*ops, ablate=ablate, **kw)
    prod = clt.row_products(*ops, seed_base=kw["seed_base"], tile0=37,
                            rows=torch.arange(kw["valid"], device=cuda),
                            ablate=ablate)
    twin = clt.finals_twin(prod, 1000.0, ablate)
    torch.cuda.synchronize()
    if ablate == "nomm":
        assert torch.equal(fk, twin)
    else:
        np.testing.assert_allclose(fk.cpu().numpy(), twin.cpu().numpy(),
                                   rtol=CLT_KERNEL_REL, atol=0)


@pytest.mark.parametrize("sampler,key", [("icdf", "month_loop_gaussian"),
                                         ("clt", "clt")])
def test_engine_gaussian_launch_counts(cuda, sampler, key):
    """The Gaussian samplers launch their own kernel once per chunk, and
    the result on the card matches the CPU run."""
    args = (smt.GaussianReturns(), 3 * 8192 + 123, 24)
    ce.reset_launch_counts()
    got = smt.simulate_stats(*args, seed=4, target_amount=1000.0,
                             keep_final_values=True,
                             options=smt.EngineOptions(
                                 chunk_paths=8192, gaussian_sampler=sampler))
    assert ce.LAUNCHES == dict({k: 0 for k in ce.LAUNCHES}, **{key: 4})
    want = smt.simulate_stats(*args, seed=4, target_amount=1000.0,
                              keep_final_values=True,
                              options=smt.EngineOptions(
                                  chunk_paths=8192, gaussian_sampler=sampler,
                                  device="cpu"))
    np.testing.assert_allclose(got.final_values, want.final_values,
                               rtol=CLT_KERNEL_REL, atol=0)
    assert got.histogram_counts.sum() == want.histogram_counts.sum()


def test_engine_on_cuda_matches_cpu(cuda):
    model = smt.HistoricalBootstrap.from_csv()
    strategy = smt.FixedPercentWithdrawal(0.3)
    args = (model, 3 * 8192 + 123, 12)
    kw = dict(seed=4, strategy=strategy, target_amount=1000.0)
    got = smt.simulate_stats(*args, keep_final_values=True,
                             options=smt.EngineOptions(chunk_paths=8192),
                             **kw)
    want = smt.simulate_stats(*args, keep_final_values=True,
                              options=smt.EngineOptions(chunk_paths=8192,
                                                        device="cpu"), **kw)
    np.testing.assert_array_equal(got.final_values, want.final_values)
    assert got.moments.count_below == want.moments.count_below
    assert got.moments.mean == pytest.approx(want.moments.mean, rel=1e-6)
    np.testing.assert_array_equal(got.histogram_counts.sum(),
                                  want.histogram_counts.sum())


def test_wrappers_check_inputs_and_count_launches(cuda):
    flat, n = ce._pad_table(_table("n1127"))
    table = torch.as_tensor(flat, device=cuda)
    keep = torch.ones((12,), dtype=torch.float32, device=cuda)
    kw = _month_kw("none", n, 12, 4096, True)
    ce.reset_launch_counts()
    ce.month_loop_chunk_plain(table, keep, **kw)
    assert ce.LAUNCHES["month_loop"] == 0
    ce.month_loop_chunk(table, keep, **kw)
    assert ce.LAUNCHES["month_loop"] == 1
    with pytest.raises(TypeError):
        ce.month_loop_chunk(table.double(), keep, **kw)
    with pytest.raises(ValueError):
        ce.month_loop_chunk(table, keep[:6], **kw)
    assert ce.LAUNCHES["month_loop"] == 1
    # past the in-place histogram's 4096 cells: the finals go through the
    # histogram kernel
    ce.month_loop_chunk(table, keep, **dict(kw, hb=20002))
    assert ce.LAUNCHES["month_loop"] == 2 and ce.LAUNCHES["histogram"] == 1


# ---------------------------------------------------------------------------
# Band kernels, bands, trajectories, segments
# ---------------------------------------------------------------------------


def _band_args(cuda, reduce_kind, draw, strategy, n_periods=24, n_cells=None,
               table_name="n1127", valid=2 * 8192 + 1001, n_paths=4 * 8192,
               tile0=37):
    """(table, keep, coef_a, coef_b), kwargs of one band chunk with the
    coefficients simulate_bands builds."""
    from stock_market_monte_carlo_torch.engine import bands as bands_eng
    from stock_market_monte_carlo_torch.engine import engine as eng

    model = (smt.HistoricalBootstrap(_table(table_name))
             if draw == "historical" else smt.GaussianReturns())
    strat = {"none": smt.NoWithdrawal(),
             "fixed_percent": smt.FixedPercentWithdrawal(0.4),
             "variable_percent": smt.VariablePercentWithdrawal(
                 np.random.default_rng(5).uniform(0.0, 1.0, n_periods)
                 .astype(np.float32)),
             # 60 % a month: every path through the denormals to 0
             "depleting": smt.VariablePercentWithdrawal(
                 np.full(n_periods, 60.0, np.float32))}[strategy]
    centers, scales = bands_eng.band_grid(model, strat, n_periods, 1000.0)
    if reduce_kind == "hist":
        n_bins = n_cells or 1024
        ca, cb, _ = bands_eng.hist_coefficients(centers, scales, n_bins,
                                                1000.0)
        reduce_kw = dict(n_bins=n_bins, coef_a_host=ca)
    else:
        k = n_cells or 32
        ca, cb, klo, khi, _, _ = bands_eng.cdf_coefficients(centers, scales,
                                                            k, 1000.0)
        reduce_kw = dict(kappa_lo=klo, kappa_hi=khi, n_thresholds=k,
                         coef_b_host=cb)
    table, draw_kw = ce.draw_operands(model, cuda)
    keep = (None if strategy == "none" else torch.as_tensor(
        eng._keep_factors_np(strat, n_periods), device=cuda))
    kw = dict(n_periods=n_periods, seed_base=0x9E3779B9, tile0=tile0,
              valid=valid, n_paths=n_paths, v0=1000.0, **draw_kw,
              **reduce_kw)
    return (table, keep, torch.as_tensor(ca, device=cuda),
            torch.as_tensor(cb, device=cuda)), kw


def _band_fns(reduce_kind):
    from stock_market_monte_carlo_torch.ops import bands as kb

    return ((kb.month_hist_chunk, kb.month_hist_chunk_plain)
            if reduce_kind == "hist"
            else (kb.month_cdf_chunk, kb.month_cdf_chunk_plain))


def _assert_band_kernel_matches_plain(reduce_kind, ops, kw):
    chunk, plain = _band_fns(reduce_kind)
    got, want = chunk(*ops, **kw), plain(*ops, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    if reduce_kind == "hist":
        assert bool((got.sum(1) == kw["valid"]).all())


@pytest.mark.parametrize("reduce_kind", ["hist", "cdf"])
@pytest.mark.parametrize("draw", ["historical", "gaussian"])
@pytest.mark.parametrize("strategy", ["none", "fixed_percent",
                                      "variable_percent"])
def test_band_kernels_match_plain(cuda, reduce_kind, draw, strategy):
    _assert_band_kernel_matches_plain(
        reduce_kind, *_band_args(cuda, reduce_kind, draw, strategy))


@pytest.mark.parametrize("reduce_kind,n_cells", [("hist", 101),
                                                 ("hist", 4094),
                                                 ("cdf", 8), ("cdf", 64)])
@pytest.mark.parametrize("n_periods,valid", [(1, 1), (2, 8192 + 3),
                                             (37, 3 * 8192)])
def test_band_kernel_shapes_match_plain(cuda, reduce_kind, n_cells,
                                        n_periods, valid):
    _assert_band_kernel_matches_plain(reduce_kind, *_band_args(
        cuda, reduce_kind, "historical", "fixed_percent", n_periods,
        n_cells, valid=valid))


@pytest.mark.parametrize("reduce_kind", ["hist", "cdf"])
@pytest.mark.parametrize("table_name", ["hostile_n97", "n20000"])
def test_band_kernel_tables_match_plain(cuda, reduce_kind, table_name):
    _assert_band_kernel_matches_plain(reduce_kind, *_band_args(
        cuda, reduce_kind, "historical", "none", table_name=table_name))


def test_band_wrappers_check_inputs_and_count_launches(cuda):
    ops, kw = _band_args(cuda, "cdf", "gaussian", "none")
    chunk, plain = _band_fns("cdf")
    ce.reset_launch_counts()
    plain(*ops, **kw)
    assert ce.LAUNCHES["bands_cdf"] == 0
    chunk(*ops, **kw)
    assert ce.LAUNCHES["bands_cdf"] == 1
    # thresholds that do not increase along k
    with pytest.raises(ValueError, match="increase"):
        chunk(*ops, **dict(kw, kappa_lo=2.0))
    with pytest.raises(ValueError, match="increase"):
        chunk(ops[0], ops[1], ops[2], -ops[3],
              **dict(kw, coef_b_host=-kw["coef_b_host"]))
    # the order is checked on the host copy, which the card route needs
    with pytest.raises(ValueError, match="coef_b_host"):
        chunk(*ops, **dict(kw, coef_b_host=None))
    with pytest.raises(TypeError):
        chunk(ops[0], ops[1], ops[2].double(), ops[3], **kw)
    hops, hkw = _band_args(cuda, "hist", "historical", "none",
                           table_name="n20000")
    # the table (80 KB) and one month of 20002 cells and their edges
    # (160 KB)
    with pytest.raises(ValueError, match="shared memory"):
        _band_fns("hist")[0](*hops, **dict(hkw, n_bins=20000))
    # the cells must not decrease as V grows: A_t > 0, checked on the
    # host copy, which the card route needs
    with pytest.raises(ValueError, match="coef_a"):
        _band_fns("hist")[0](*hops, **dict(hkw, coef_a_host=-hkw[
            "coef_a_host"]))
    with pytest.raises(ValueError, match="coef_a_host"):
        _band_fns("hist")[0](*hops, **dict(hkw, coef_a_host=None))
    assert ce.LAUNCHES["bands_cdf"] == 1 and ce.LAUNCHES["bands_hist"] == 0


@pytest.mark.parametrize("draw", ["historical", "gaussian"])
@pytest.mark.parametrize("b_t", [1e-7, 10.0])
def test_cdf_kernel_matches_plain_at_adversarial_thresholds(cuda, draw, b_t):
    """B_t = 1e-7 about each month's centre (thresholds tied in float32,
    the guess off by more than its check) and B_t = 10 (thresholds +inf
    above and 0 below), at 360 months."""
    from stock_market_monte_carlo_torch.engine import bands as bands_eng

    ops, kw = _band_args(cuda, "cdf", draw, "none", n_periods=360,
                         valid=3 * 8192 + 1, n_paths=4 * 8192)
    model = (smt.HistoricalBootstrap(_table("n1127"))
             if draw == "historical" else smt.GaussianReturns())
    centers, _ = bands_eng.band_grid(model, smt.NoWithdrawal(), 360, 1000.0)
    cb = np.full(360, b_t, np.float32)
    ops = (*ops[:2], torch.as_tensor(centers[1:].astype(np.float32),
                                     device=cuda),
           torch.as_tensor(cb, device=cuda))
    _assert_band_kernel_matches_plain("cdf", ops, dict(kw, coef_b_host=cb))


@pytest.mark.parametrize("reduce_kind", ["hist", "cdf"])
@pytest.mark.parametrize("strategy", ["fixed_percent", "depleting"])
def test_band_kernels_match_plain_on_hostile_table(cuda, reduce_kind,
                                                   strategy):
    """The hostile 97-row table at 360 months; under 60 % withdrawals a
    month every value passes through the denormals to 0."""
    _assert_band_kernel_matches_plain(reduce_kind, *_band_args(
        cuda, reduce_kind, "historical", strategy, n_periods=360,
        table_name="hostile_n97"))


@pytest.mark.parametrize("valid", [1, 255, 257, 8192 + 1, 3 * 8192 - 1])
def test_cdf_kernel_partial_items_match_plain(cuda, valid):
    """Chunks that end inside a 256-path warp item, or leave the rest of
    a tile and most warps of the grid without paths."""
    _assert_band_kernel_matches_plain("cdf", *_band_args(
        cuda, "cdf", "gaussian", "fixed_percent", n_periods=60, valid=valid))


@pytest.mark.parametrize("table_name,n_periods,k,copies", [
    ("n1127", 360, 32, 4), ("n20000", 360, 32, 2), ("n1127", 2048, 8, 2),
    ("n32000", 512, 32, 1)])
def test_cdf_kernel_copies_match_plain(cuda, table_name, n_periods, k,
                                       copies):
    """The counts-below kernel with 4, 2 and 1 copies of its count table
    (as many as fit in a block's shared memory beside the table)."""
    from stock_market_monte_carlo_torch.ops import bands as kb

    ops, kw = _band_args(cuda, "cdf", "historical", "none",
                         n_periods=n_periods, n_cells=k,
                         table_name=table_name, valid=8192 + 3,
                         n_paths=2 * 8192)
    plan = kb.kernel_info(1, "historical", keep=False,
                          n_table=kw["n_table"], n_periods=n_periods,
                          valid=kw["valid"], n_cells=k)
    assert plan["copies"] == copies and plan["threads"] == 256 * copies
    _assert_band_kernel_matches_plain("cdf", ops, kw)


def test_band_kernel_plans(cuda):
    """A main chunk's launch: both kernels in blocks of 1024 threads, the
    blocks that fit on the card; the counts below thresholds with 4
    copies, all months at once; the histogram in 14 windows of 26 months
    (27 months of 1026 cells and 1025 edges fit beside the 1127-row
    table, evened out), the Gaussian draw's in 13 of 28 (28 fit without a
    table). A chunk of fewer warp items than the card's warps takes fewer
    blocks."""
    from stock_market_monte_carlo_torch.ops import bands as kb

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cdf = kb.kernel_info(1, "gaussian", keep=False, n_table=0,
                         n_periods=360, valid=1 << 24, n_cells=32)
    assert cdf["copies"] == 4 and cdf["threads"] == 1024
    assert cdf["grid"] == sms * cdf["blocks_per_sm"] > 0
    assert (cdf["window"], cdf["windows"]) == (360, 1)
    for draw, n_table, window, windows in (("historical", 1127, 26, 14),
                                           ("gaussian", 0, 28, 13)):
        hist = kb.kernel_info(0, draw, keep=True, n_table=n_table,
                              n_periods=360, valid=1 << 24, n_cells=1026)
        assert hist["threads"] == 1024 and hist["copies"] == 1
        assert hist["grid"] == sms * hist["blocks_per_sm"] > 0
        assert (hist["window"], hist["windows"]) == (window, windows)
        assert hist["dynamic_smem"] == 4 * (-(-n_table // 128) * 128
                                            + window * (2 * 1026 - 1))
        assert {k: hist[k] for k in ("window", "windows", "grid")} == {
            k: v for k, v in kb.hist_plan_twin(
                1 << 24, 360, 1026, n_table, sms,
                hist["blocks_per_sm"]).items() if k != "threads"}
    small = kb.kernel_info(0, "historical", keep=False, n_table=1127,
                           n_periods=12, valid=3 * 8192, n_cells=1026)
    assert small["grid"] == 3 and (small["window"], small["windows"]) == (
        12, 1)
    # near the largest month that fits beside the table: one a window
    one = kb.kernel_info(0, "historical", keep=False, n_table=97,
                         n_periods=5, valid=8192, n_cells=28000)
    assert (one["window"], one["windows"]) == (1, 5)


def test_cuda_log_does_not_decrease_over_the_floats(cuda):
    """The band histogram counts a value in the number of its month's cell
    edges it is not below (ops/bands.hist_edges), which is its cell where
    the cell does not decrease as the value grows: torch.log on the card
    must not decrease over the floats it is given. Every non-negative
    float, 0 to the largest finite float and +inf, in slices (each slice's
    first log against the last of the slice before)."""
    last = torch.full((), -float("inf"), device=cuda)
    end = int(np.float32(np.inf).view(np.int32)) + 1
    step = 1 << 26
    for start in range(0, end, step):
        bits = torch.arange(start, min(start + step, end), dtype=torch.int32,
                            device=cuda)
        y = torch.log(bits.view(torch.float32))
        assert not bool(torch.isnan(y).any())
        assert bool((y[1:] >= y[:-1]).all()) and bool(y[0] >= last)
        last = y[-1]
    assert float(last) == float("inf")


def test_hist_edges_on_the_card_are_the_cells_least_values(cuda):
    """The edges of a 360-month grid of 1024 bins, bisected on the card:
    each edge's cell is at least its cell and the float before it is in
    a lower one (or the edge is the least value, 1e-37), under the card's
    log."""
    from stock_market_monte_carlo_torch.ops import bands as kb

    (_, _, ca, cb), _ = _band_args(cuda, "hist", "historical", "none",
                                   n_periods=360)
    edges = kb.hist_edges(ca, cb, 1024)
    c = torch.arange(1, 1026, device=cuda)
    prev = (edges.view(torch.int32) - 1).view(torch.float32)
    tiny = float(np.float32(1e-37))
    assert bool((kb.hist_cells(edges, ca[:, None], cb[:, None], 1024)
                 >= c).all())
    assert bool(((kb.hist_cells(prev, ca[:, None], cb[:, None], 1024) < c)
                 | (edges == tiny)).all())


@pytest.mark.parametrize("draw", ["historical", "gaussian"])
@pytest.mark.parametrize("strategy", ["none", "fixed_percent"])
@pytest.mark.parametrize("valid", [1, 255, 257, 8191, 3 * 8192 - 1])
def test_hist_kernel_partial_items_match_plain(cuda, draw, strategy, valid):
    """Chunks that end inside a 256-path warp item or a tile (one window
    of 60 months), with and without a keep factor."""
    _assert_band_kernel_matches_plain("hist", *_band_args(
        cuda, "hist", draw, strategy, n_periods=60, valid=valid))


@pytest.mark.parametrize("draw,table_name", [("historical", "n1127"),
                                             ("historical", "hostile_n97"),
                                             ("gaussian", "n1127")])
@pytest.mark.parametrize("n_bins,n_periods", [(4093, 360), (20001, 37),
                                              (28000, 5)])
def test_hist_kernel_windows_match_plain(cuda, draw, table_name, n_bins,
                                         n_periods):
    """Windows of months: 4095 cells (6 months a window at 360 months
    beside the 1127-row table, 60 windows), 20003 and 28002 (one month a
    window; 28002 near the most cells that fit beside the 1127-row table),
    at a ragged chunk under a keep factor."""
    _assert_band_kernel_matches_plain("hist", *_band_args(
        cuda, "hist", draw, "fixed_percent", n_periods=n_periods,
        n_cells=n_bins, table_name=table_name))


@pytest.mark.parametrize("mode", ["hist", "cdf"])
@pytest.mark.parametrize("kind", ["historical", "gaussian"])
def test_simulate_bands_on_cuda_matches_cpu(cuda, mode, kind):
    """Bands on the card against the plain versions on the CPU: the
    kernels launch once per chunk; the masses agree exactly; a cell may
    differ for a value within an ulp of an edge (the two devices' log,
    and for the Gaussian draw log1p, differ in the last bit)."""
    model = (smt.HistoricalBootstrap.from_csv() if kind == "historical"
             else smt.GaussianReturns())
    n = 3 * 8192 + 123
    kw = dict(seed=4, strategy=smt.FixedPercentWithdrawal(0.2),
              band_mode=mode, sample_paths=5)
    ce.reset_launch_counts()
    got = smt.simulate_bands(model, n, 24, options=smt.EngineOptions(
        chunk_paths=8192), **kw)
    key = "bands_hist" if mode == "hist" else "bands_cdf"
    assert ce.LAUNCHES == dict({k: 0 for k in ce.LAUNCHES}, **{key: 4})
    want = smt.simulate_bands(model, n, 24, options=smt.EngineOptions(
        chunk_paths=8192, device="cpu"), **kw)
    if mode == "hist":
        np.testing.assert_array_equal(got.month_hist.sum(1), n)
    assert np.abs(got.month_hist - want.month_hist).max() <= 2
    np.testing.assert_allclose(got.values, want.values, rtol=1e-4)
    np.testing.assert_allclose(got.sample_paths, want.sample_paths,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["hist", "cdf"])
def test_simulate_bands_waits_for_one_chunk_at_a_time(cuda, mode):
    """The band loop absorbs chunk i while chunk i+1 runs and waits for
    chunk i's counts alone: each chunk's counts are copied to pinned
    memory behind its own kernel, and the loop waits on that copy's
    event. A .cpu() of the counts would wait for the stream (chunk i+1's
    kernel too), which torch's sync debug mode "error" refuses: it is on
    from the first absorbed chunk to the last."""
    model = smt.GaussianReturns()
    n = 5 * 8192 + 77
    seen = []

    def progress(done, total):
        seen.append(done)
        torch.cuda.set_sync_debug_mode("error" if done < total
                                       else "default")

    try:
        got = smt.simulate_bands(model, n, 24, seed=4, band_mode=mode,
                                 sample_paths=3, progress=progress,
                                 options=smt.EngineOptions(chunk_paths=8192))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert seen == [8192, 2 * 8192, 3 * 8192, 4 * 8192, 5 * 8192, n]
    want = smt.simulate_bands(model, n, 24, seed=4, band_mode=mode,
                              sample_paths=3, options=smt.EngineOptions(
                                  chunk_paths=8192, device="cpu"))
    assert np.abs(got.month_hist - want.month_hist).max() <= 2


@pytest.mark.parametrize("kind", ["historical", "gaussian"])
def test_simulate_paths_on_cuda_matches_cpu(cuda, kind):
    model = (smt.HistoricalBootstrap.from_csv() if kind == "historical"
             else smt.GaussianReturns())
    args = (model, 300, 24, 1000.0, 3, smt.FixedAmountWithdrawal(5.0))
    got = smt.simulate_paths(*args, path_offset=8000)
    want = smt.simulate_paths(*args, path_offset=8000,
                              options=smt.EngineOptions(device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)


def test_segmented_run_on_cuda_matches_cpu(cuda):
    """Four seed segments of one tile each: one launch per segment, and
    the historical finals as on the CPU, bit for bit."""
    args = (smt.HistoricalBootstrap.from_csv(), 3 * 8192 + 5, 12)
    opts = dict(chunk_paths=2 * 8192, seed_segment_paths=8192)
    ce.reset_launch_counts()
    got = smt.simulate_final_values(*args, seed=9,
                                    options=smt.EngineOptions(**opts))
    assert ce.LAUNCHES["month_loop"] == 4
    want = smt.simulate_final_values(*args, seed=9, options=smt.EngineOptions(
        device="cpu", **opts))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The Sobol and reference-parity draws of the month loop
# ---------------------------------------------------------------------------

NEW_DRAWS = ("sobol_gaussian", "sobol_historical", "reference")


def _draw_model(draw, n_periods, index_offset=0, table_name="n1127"):
    table = _table(table_name)
    if draw == "sobol_gaussian":
        return smt.SobolGaussianReturns.create(n_periods,
                                               index_offset=index_offset)
    if draw == "sobol_historical":
        return smt.SobolHistoricalBootstrap.create(table, n_periods,
                                                   index_offset=index_offset)
    return smt.HistoricalBootstrap(table, rng="reference")


def _draw_args(cuda, draw, strategy, n_periods=24, index_offset=0,
               table_name="n1127", hb=4096, with_hist=True, **over):
    """(table, keep), kwargs of one month-loop chunk of a new draw, with
    the operands the engine builds (seed 5's digital shift)."""
    from stock_market_monte_carlo_torch.ops import sobol, threefry

    model = _draw_model(draw, n_periods, index_offset, table_name)
    shift = sobol.digital_shift(
        threefry.fold_in(threefry.key(5), 0x50B0), n_periods)
    table, draw_kw = ce.draw_operands(model, cuda, n_periods,
                                      shift if model.is_quasi else None)
    keep = torch.as_tensor(np.random.default_rng(5).uniform(
        0.99, 1.0, n_periods).astype(np.float32), device=cuda)
    kw = dict(_month_kw(strategy, 0, n_periods, hb, with_hist), **draw_kw)
    return (table, keep), dict(kw, **over)


def _assert_draw_matches_plain(ops, kw):
    _assert_kernel_matches_plain(ce.month_loop_chunk(*ops, **kw),
                                 ce.month_loop_chunk_plain(*ops, **kw))


# the 32-bit path ids wrap to 0 after this tile
WRAP_TILE0 = (1 << 19) - 1


@pytest.mark.parametrize("draw", NEW_DRAWS)
@pytest.mark.parametrize("strategy", ["none", "fixed_percent",
                                      "variable_percent", "fixed_amount"])
@pytest.mark.parametrize("hb,with_hist", [(4096, True), (102, True),
                                          (4096, False)])
@pytest.mark.parametrize("tile0,valid", [
    *((37, 2 * 8192 + 1000 + r) for r in range(16) if r != 8),
    (WRAP_TILE0, 2 * 8192 + 1003)])
def test_new_draw_kernels_match_plain(cuda, draw, strategy, hb, with_hist,
                                      tile0, valid):
    """Bit for bit, at a ragged chunk of 4*8192 paths at tile offset 37
    whose valid paths leave 1 .. 15 of a Sobol run of 16 (the historical
    draw's paths a thread; 1 .. 7 of the Gaussian's 8) over, and across the
    32-bit path ids' wrap at 2^32."""
    _assert_draw_matches_plain(*_draw_args(cuda, draw, strategy, hb=hb,
                                           with_hist=with_hist, tile0=tile0,
                                           valid=valid))


@pytest.mark.parametrize("draw", ["sobol_gaussian", "sobol_historical"])
@pytest.mark.parametrize("index_offset", [
    (1 << 33) + 777, (1 << 32) - 40000, (1 << 62) - (1 << 20),
    *((1 << 33) + 777 + r for r in range(1, 7)), 3, (1 << 32) - 3])
def test_sobol_deep_kernels_match_plain(cuda, draw, index_offset):
    """64-bit positions: past 2^33, a carry into the high word inside the
    chunk and inside a thread's run (2^32 - 3), near the 2^62 end, and
    offsets of every residue 1 .. 7 mod 8 (the runs' first positions off
    a multiple of 8)."""
    _assert_draw_matches_plain(*_draw_args(cuda, draw, "fixed_percent",
                                           index_offset=index_offset))


@pytest.mark.parametrize("draw", ["sobol_gaussian", "sobol_historical"])
@pytest.mark.parametrize("strategy", ["none", "fixed_percent",
                                      "variable_percent", "fixed_amount"])
@pytest.mark.parametrize("index_offset", [0, 777, (1 << 32) - 3])
def test_sobol_windows_match_plain(cuda, draw, strategy, index_offset):
    """360 months: the kernel stages the direction rows in windows of
    months (124 at 32-bit positions, 63 at 64-bit) and restages them for
    each group of runs; at a ragged chunk (valid paths leave 13 of a run
    of 16, 5 of 8) at tile offset 3, under every strategy."""
    _assert_draw_matches_plain(*_draw_args(
        cuda, draw, strategy, n_periods=360, index_offset=index_offset,
        valid=2 * 8192 + 1005, tile0=3))


@pytest.mark.parametrize("draw,index_offset", [
    ("sobol_gaussian", 0), ("sobol_gaussian", (1 << 33) + 777),
    ("sobol_historical", 0), ("sobol_historical", (1 << 33) + 777),
    ("reference", 0)])
def test_new_draws_at_360_months_match_plain(cuda, draw, index_offset):
    """The full horizon: 360 x 32 (or x 64) direction words in shared
    memory beside the histogram."""
    _assert_draw_matches_plain(*_draw_args(
        cuda, draw, "none", n_periods=360, index_offset=index_offset,
        valid=8192 + 3, n_paths=2 * 8192))


@pytest.mark.parametrize("draw", ["sobol_historical", "reference"])
@pytest.mark.parametrize("table_name", ["hostile_n97", "n20000"])
def test_new_draw_tables_match_plain(cuda, draw, table_name):
    _assert_draw_matches_plain(*_draw_args(cuda, draw, "fixed_amount",
                                           table_name=table_name))


def test_new_draw_wrappers_check_inputs_and_count_launches(cuda):
    ops, kw = _draw_args(cuda, "sobol_gaussian", "none")
    ce.reset_launch_counts()
    ce.month_loop_chunk_plain(*ops, **kw)
    assert ce.LAUNCHES["month_loop_sobol_gaussian"] == 0
    ce.month_loop_chunk(*ops, **kw)
    assert ce.LAUNCHES["month_loop_sobol_gaussian"] == 1
    with pytest.raises(ValueError, match="needs direction"):
        ce.month_loop_chunk(*ops, **dict(kw, sobol_shift=None))
    with pytest.raises(TypeError):
        ce.month_loop_chunk(*ops, **dict(kw, direction=kw["direction"]
                                         .long()))
    with pytest.raises(ValueError, match="64"):
        ce.month_loop_chunk(*ops, **dict(kw, index_offset=5))
    with pytest.raises(ValueError, match="shape"):
        ce.month_loop_chunk(*ops, **dict(kw, direction=kw["direction"][:6]))
    # 900 x 65 direction words do not fit in shared memory at once: staged
    # in windows of months
    deep_ops, deep_kw = _draw_args(cuda, "sobol_historical", "none",
                                   n_periods=900, index_offset=3)
    ce.month_loop_chunk(*deep_ops, **deep_kw)
    assert ce.LAUNCHES["month_loop_sobol_historical"] == 1
    ref_ops, ref_kw = _draw_args(cuda, "reference", "none")
    with pytest.raises(ValueError, match="no Sobol operands"):
        ce.month_loop_chunk(*ref_ops, **dict(ref_kw, sobol_shift=kw[
            "sobol_shift"]))
    assert sum(ce.LAUNCHES.values()) == 2


@pytest.mark.parametrize("draw", NEW_DRAWS)
def test_engine_new_draw_launch_counts(cuda, draw):
    """Each new draw launches its own kernel once per chunk, and the
    results on the card equal the CPU run's (Sobol Gaussian within the
    two devices' log1p ulp)."""
    model = _draw_model(draw, 24)
    args = (model, 3 * 8192 + 123, 24)
    kw = dict(seed=4, strategy=smt.FixedPercentWithdrawal(0.3),
              target_amount=1000.0, keep_final_values=True)
    ce.reset_launch_counts()
    got = smt.simulate_stats(*args, options=smt.EngineOptions(
        chunk_paths=8192), **kw)
    key = ce.MONTH_LOOP_COUNTERS[draw]
    assert ce.LAUNCHES == dict({k: 0 for k in ce.LAUNCHES}, **{key: 4})
    want = smt.simulate_stats(*args, options=smt.EngineOptions(
        chunk_paths=8192, device="cpu"), **kw)
    rel = 1e-6 if draw == "sobol_gaussian" else 0.0
    np.testing.assert_allclose(got.final_values, want.final_values,
                               rtol=rel, atol=0)
    assert got.histogram_counts.sum() == want.histogram_counts.sum()


@pytest.mark.parametrize("draw", NEW_DRAWS)
def test_new_draw_trajectories_and_bands_on_cuda_match_cpu(cuda, draw):
    model = _draw_model(draw, 24, index_offset=7 if draw != "reference"
                        else 0)
    args = (model, 300, 24, 1000.0, 3, smt.FixedPercentWithdrawal(0.2))
    got = smt.simulate_paths(*args, path_offset=8000)
    want = smt.simulate_paths(*args, path_offset=8000,
                              options=smt.EngineOptions(device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    kw = dict(seed=4, sample_paths=3, n_bins=256)
    ce.reset_launch_counts()
    got = smt.simulate_bands(model, 8192 + 77, 24, **kw)
    assert sum(ce.LAUNCHES.values()) == 0   # no band kernel draws these
    want = smt.simulate_bands(model, 8192 + 77, 24, options=smt.EngineOptions(
        device="cpu"), **kw)
    np.testing.assert_array_equal(got.month_hist.sum(1), 8192 + 77)
    assert np.abs(got.month_hist - want.month_hist).max() <= 2
    np.testing.assert_allclose(got.values, want.values, rtol=1e-4)


def test_rqmc_on_cuda_matches_cpu(cuda):
    model = smt.SobolGaussianReturns.create(24)
    got = smt.rqmc_estimate(model, 8192 + 5, 24, replicates=3,
                            options=smt.EngineOptions(chunk_paths=8192))
    want = smt.rqmc_estimate(model, 8192 + 5, 24, replicates=3,
                             options=smt.EngineOptions(chunk_paths=8192,
                                                       device="cpu"))
    np.testing.assert_allclose(got.replicate_means, want.replicate_means,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# The headline's calibration kernels and the counts below a tile
# ---------------------------------------------------------------------------

HEADLINE_TILES = (1 << 24) // 8192


@pytest.mark.parametrize("variant", ["const", "counter"])
@pytest.mark.parametrize("group", [1, 16])
def test_grid_overhead_kernel_matches_plain(cuda, variant, group):
    """The 2^24-path shape, bit for bit (the column sums run in row order
    in both)."""
    from stock_market_monte_carlo_torch.ops import calibration as cal

    kw = dict(seed=12345, n_tiles=HEADLINE_TILES, tile0=3, device=cuda)
    got = cal.grid_overhead_chunk(variant, group, **kw)
    want = cal.grid_overhead_chunk_plain(variant, group, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("variant", ["const", "counter"])
def test_grid_overhead_groups_agree(cuda, variant):
    from stock_market_monte_carlo_torch.ops import calibration as cal

    one, sixteen = (cal.grid_overhead_chunk(variant, g, seed=7,
                                            n_tiles=HEADLINE_TILES,
                                            device=cuda) for g in (1, 16))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, sixteen))


@pytest.mark.parametrize("n_ops", [16, 48])
@pytest.mark.parametrize("n_paths,tile0", [(1 << 20, 0),
                                           (3 * 8192, 37)])
def test_calib_kernel_matches_plain(cuda, n_ops, n_paths, tile0):
    """360 months, bit for bit (-fmad=false: 1 + y * 1e-12 rounds twice
    in both); a ragged chunk of three tiles at tile offset 37 (which adds
    to the seed)."""
    from stock_market_monte_carlo_torch.ops import calibration as cal

    kw = dict(n_periods=360, n_paths=n_paths, seed=123 + tile0,
              device=cuda)
    got = cal.calib_chunk(n_ops, **kw)
    want = cal.calib_chunk_plain(n_ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("n_thr", [8, 32, 64])
def test_counts_below_tile_kernel_matches_plain(cuda, n_thr):
    from stock_market_monte_carlo_torch.ops import bands as kb

    rng = np.random.default_rng(11)
    tl = np.exp(rng.normal(size=(64, 128)).astype(np.float32))
    thr = np.exp(rng.normal(size=(n_thr, 128)).astype(np.float32))
    thr[n_thr // 2] = tl[3]     # ties: strictly below excludes them
    ops = (torch.as_tensor(tl, device=cuda), torch.as_tensor(thr,
                                                             device=cuda))
    got = kb.counts_below_tile(*ops)
    want = kb.counts_below_tile_plain(*ops)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_calibration_wrappers_check_inputs_and_count_launches(cuda):
    from stock_market_monte_carlo_torch.ops import bands as kb
    from stock_market_monte_carlo_torch.ops import calibration as cal

    ce.reset_launch_counts()
    cal.calib_chunk_plain(16, n_periods=8, n_paths=8192, seed=1,
                          device=cuda)
    cal.grid_overhead_chunk_plain("const", 1, seed=1, n_tiles=2,
                                  device=cuda)
    assert sum(ce.LAUNCHES.values()) == 0
    cal.calib_chunk(16, n_periods=8, n_paths=8192, seed=1, device=cuda)
    cal.grid_overhead_chunk("counter", 2, seed=1, n_tiles=2, device=cuda)
    kb.counts_below_tile(torch.ones((64, 128), device=cuda),
                         torch.ones((8, 128), device=cuda))
    assert (ce.LAUNCHES["calib"], ce.LAUNCHES["grid_overhead"],
            ce.LAUNCHES["counts_below_tile"]) == (1, 1, 1)
    with pytest.raises(ValueError, match="built for"):
        cal.calib_chunk(20, n_periods=8, n_paths=8192, seed=1, device=cuda)
    with pytest.raises(ValueError, match="groups"):
        cal.grid_overhead_chunk("const", 16, seed=1, n_tiles=8, device=cuda)
    with pytest.raises(TypeError):
        kb.counts_below_tile(torch.ones((64, 128), device=cuda).double(),
                             torch.ones((8, 128), device=cuda))
    assert sum(ce.LAUNCHES.values()) == 3


def test_calib_sass_instructions(cuda):
    """The month loop of each calibration kernel is found in the built
    library's SASS; 32 more operators a month cost more instructions, and
    fewer than 32 each for the IMAD that folds the multiply and the add."""
    from stock_market_monte_carlo_torch.ops import calibration as cal

    instr = cal.calib_sass_instructions()
    assert 16 < instr[16] < instr[48]
    assert 24 <= instr[48] - instr[16] <= 48


def test_headline_device_times_on_the_card(cuda):
    """The device-time block on 2^20-path chunks: every kernel timed and
    predicted, the 100M law run timed, a positive int32 rate."""
    from stock_market_monte_carlo_torch.bench import headline

    dt = headline.device_times(360, chunk=1 << 20, k=2, reps=1)
    for name in ("law_hist", "law_statsonly", "historical", "clt",
                 "clt_statsonly"):
        assert dt[f"{name}_ms_per_chunk"] > 0
        assert dt[f"{name}_predicted_ms_per_chunk"] > 0
    assert dt["law_hist_100m_device_ms"] > 0
    assert 0 < dt["int_op_rate_per_s"] < 1e15


# ---------------------------------------------------------------------------
# The histogram kernel, large and odd histograms, long Sobol horizons, and
# wrappers that do not synchronise
# ---------------------------------------------------------------------------


def _hist_inputs(cuda, mode, hb, n=(1 << 20) + 3):
    rng = np.random.default_rng(hb)
    if mode == "index":
        # masked lanes carry hb; a few indices fall outside [0, hb]
        x = rng.integers(-2, hb + 3, n).astype(np.int32)
        return torch.as_tensor(x, device=cuda), {}
    if mode == "clip_cast":
        x = rng.uniform(-50.0, hb + 50.0, n).astype(np.float32)
        return torch.as_tensor(x, device=cuda), {}
    lo, hi = 300.0, 3000.0
    x = np.exp(rng.uniform(np.log(lo) - 0.1, np.log(hi) + 0.1, n))
    x = x.astype(np.float32)
    x[:4] = (lo, 0.0, np.inf, np.nan)
    width = (np.log(hi) - np.log(lo)) / (hb - 2)
    return torch.as_tensor(x, device=cuda), dict(
        lo=lo, log_lo=float(np.log(lo)), inv_w=1.0 / width)


@pytest.mark.parametrize("mode", ["index", "clip_cast", "spec"])
@pytest.mark.parametrize("hb", [4096, 20000, 70000])
def test_histogram_kernel_matches_plain(cuda, mode, hb):
    """Bit for bit, and against np.bincount of the same bins: 4096 cells
    (16 KB of shared memory), 20000 (past the default 48 KB) and 70000
    (past a block's shared memory: the global-atomic cells)."""
    from stock_market_monte_carlo_torch.ops import histogram

    x, spec = _hist_inputs(cuda, mode, hb)
    got = histogram.histogram_counts(x, hb, mode=mode, **spec)
    want = histogram.histogram_plain(x, hb, mode=mode, **spec)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if mode == "index":
        bins = x.cpu().numpy()
    elif mode == "clip_cast":
        bins = histogram.clip_cast_indices(x, hb).cpu().numpy()
    else:
        bins = histogram.spec_bin_indices(
            x, n_bins=hb - 2, **spec).cpu().numpy()
    bins = bins[(bins >= 0) & (bins < hb)]
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.bincount(bins, minlength=hb))


def test_flatten_tile_kernel_matches_plain(cuda):
    from stock_market_monte_carlo_torch.ops import histogram

    x = torch.arange(5 * 8192, dtype=torch.float32, device=cuda).reshape(
        5 * 64, 128)
    got = histogram.flatten_tile(x)
    torch.cuda.synchronize()
    assert got.shape == (5 * 8192, 1)
    assert torch.equal(got, histogram.flatten_tile_plain(x))
    assert torch.equal(got[:, 0], torch.arange(5 * 8192, dtype=torch.float32,
                                               device=cuda))


@pytest.mark.parametrize("n_tiles", [1, 3, 2047])
def test_flatten_tile_kernel_odd_tile_counts(cuda, n_tiles):
    """Odd grids: a block copies one tile, so any tile count fills its
    blocks; one block, three, and one short of the main 2048."""
    from stock_market_monte_carlo_torch.ops import histogram

    x = torch.randn((n_tiles * 64, 128), generator=torch.Generator(
        device=cuda).manual_seed(n_tiles), device=cuda)
    got = histogram.flatten_tile(x)
    torch.cuda.synchronize()
    assert got.shape == (n_tiles * 8192, 1)
    assert torch.equal(got, histogram.flatten_tile_plain(x))


def test_histogram_wrappers_check_inputs_and_count_launches(cuda):
    from stock_market_monte_carlo_torch.ops import histogram

    x = torch.zeros((8192,), dtype=torch.int32, device=cuda)
    ce.reset_launch_counts()
    histogram.histogram_plain(x, 64)
    assert sum(ce.LAUNCHES.values()) == 0
    histogram.histogram_counts(x, 64)
    histogram.histogram_counts(x.float(), 64, mode="clip_cast")
    histogram.histogram_counts(x.float(), 64, mode="spec", lo=1.0,
                               log_lo=0.0, inv_w=1.0)
    histogram.flatten_tile(x.float().reshape(64, 128))
    assert {k: v for k, v in ce.LAUNCHES.items() if v} == dict(
        histogram_index=1, histogram_clip_cast=1, histogram=1,
        flatten_tile=1)
    with pytest.raises(TypeError):
        histogram.histogram_counts(x.float(), 64)
    with pytest.raises(ValueError, match="lo"):
        histogram.histogram_counts(x.float(), 64, mode="spec")
    with pytest.raises(ValueError, match="contiguous"):
        histogram.histogram_counts(x.reshape(64, 128)[:, ::2], 64)
    with pytest.raises(ValueError, match="tiles"):
        histogram.flatten_tile(x.float()[:4096].reshape(32, 128))
    assert sum(ce.LAUNCHES.values()) == 4


def _hist_density_edges(finals, spec):
    """Finals whose log lies within 1e-6 of a cell edge of ``spec``, where
    the two devices' logs may bin them a cell apart."""
    x = (np.log(finals.astype(np.float64)) - spec.log_lo) / spec.width
    return int(np.sum(np.abs(x - np.round(x)) <= 1e-6 / spec.width))


@pytest.mark.parametrize("bins", [20000, 3998])
@pytest.mark.parametrize("sampler", ["month_loop", "law", "clt"])
def test_engine_odd_histograms_on_cuda_match_cpu(cuda, sampler, bins):
    """histogram_bins past the in-place 4096 cells, and one whose cells are
    not a multiple of 64: the chunk kernels write their finals, the
    histogram kernel counts them (one launch a chunk), and the histogram
    equals the CPU run's but for finals at a cell edge."""
    model, opts, key = {
        "month_loop": (smt.HistoricalBootstrap.from_csv(), {}, "month_loop"),
        "law": (smt.HistoricalBootstrap.from_csv(),
                dict(terminal_law=True), "law"),
        "clt": (smt.GaussianReturns(), dict(gaussian_sampler="clt"), "clt"),
    }[sampler]
    args = (model, 3 * 8192 + 123, 24)
    kw = dict(seed=4, target_amount=1000.0, keep_final_values=True)
    ce.reset_launch_counts()
    got = smt.simulate_stats(*args, options=smt.EngineOptions(
        chunk_paths=8192, histogram_bins=bins, **opts), **kw)
    assert {k: v for k, v in ce.LAUNCHES.items() if v} == {key: 4,
                                                          "histogram": 4}
    want = smt.simulate_stats(*args, options=smt.EngineOptions(
        chunk_paths=8192, histogram_bins=bins, device="cpu", **opts), **kw)
    hk, hp = got.histogram_counts, want.histogram_counts
    assert hk.shape == (bins + 2,) and hk.sum() == hp.sum() == args[1]
    # the month loop's finals are bit-equal across the devices; the law's
    # and the CLT's go through exp and log, which may differ by an ulp
    differ = int(np.sum(got.final_values != want.final_values))
    assert sampler != "month_loop" or differ == 0
    near = 2 * (differ + _hist_density_edges(want.final_values,
                                             got.histogram_spec))
    assert np.abs(hk - hp).sum() <= near


@pytest.mark.parametrize("draw", ["sobol_gaussian", "sobol_historical"])
@pytest.mark.parametrize("index_offset", [0, (1 << 33) + 777])
def test_sobol_1866_months_match_plain(cuda, draw, index_offset):
    """The Sobol table's full 1866 dimensions: the direction rows no longer
    fit in shared memory (1866 x 33 or x 65 words) and are read from
    global memory; kernel == plain bit for bit, with an in-place and a
    kernel-counted histogram."""
    for hb in (4096, 1002):
        _assert_draw_matches_plain(*_draw_args(
            cuda, draw, "fixed_percent", n_periods=1866,
            index_offset=index_offset, hb=hb, valid=8192 + 3,
            n_paths=2 * 8192))


def test_counted_wrappers_do_not_synchronise(cuda):
    """Every counted chunk wrapper queues its work without waiting for the
    card: under torch's sync debug mode "error", a synchronising call
    (a host-to-device copy of a host value, .item(), .cpu()) raises."""
    from stock_market_monte_carlo_torch.ops import histogram
    from stock_market_monte_carlo_torch.ops.terminal_law import (
        LAW_ZMAX,
        fit_terminal_law,
    )

    flat, n = ce._pad_table(_table("n1127"))
    table = torch.as_tensor(flat, device=cuda)
    keep = torch.ones((24,), dtype=torch.float32, device=cuda)
    month_kw = dict(_month_kw("none", n, 24, 4096, True), keep_finals=False)
    law_host = fit_terminal_law(smt.GaussianReturns(), smt.NoWithdrawal(),
                                120, 1000.0).operand()
    law = torch.as_tensor(law_host, device=cuda)
    law_kw = dict(seed_base=0x80000001, tile0=5, valid=3 * 8192 + 17,
                  n_paths=4 * 8192, v0=1000.0, target=1500.0, shift=1.8,
                  inv_zmax=1.0 / LAW_ZMAX, lo=200.0,
                  log_lo=float(np.log(200.0)), inv_w=1000.0, hb=4096,
                  with_hist=True, keep_finals=False, law_host=law_host)
    sobol_cases = [_draw_args(cuda, "sobol_historical", "fixed_percent",
                              index_offset=offset, keep_finals=False)
                   for offset in (0, 777)]
    clt_ops = _clt_operands(cuda, "plain", 24)
    clt_kw = dict(variant="plain", seed_base=5, tile0=0, valid=8192 + 5,
                  n_paths=2 * 8192, v0=1000.0, target=1000.0, shift=1.0,
                  lo=300.0, log_lo=float(np.log(300.0)), inv_w=2000.0,
                  hb=4096, with_hist=True, keep_finals=False)
    idx = torch.zeros((8192,), dtype=torch.int32, device=cuda)
    from stock_market_monte_carlo_torch.ops import bands as kb

    band_cases = [(kb.month_hist_chunk,
                   _band_args(cuda, "hist", "historical", "fixed_percent")),
                  (kb.month_hist_chunk,
                   _band_args(cuda, "hist", "gaussian", "none",
                              n_periods=120)),
                  (kb.month_cdf_chunk,
                   _band_args(cuda, "cdf", "gaussian", "none"))]
    a, b = ce.gaussian_ab(0.5, 10.0 / 12)
    gauss_kw = dict(_month_kw("fixed_percent", 0, 24, 4096, True),
                    draw="gaussian", a=a, b=b, keep_finals=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            ce.month_loop_chunk(table, keep, **dict(month_kw, tile0=i))
            ce.month_loop_chunk(table, keep, **dict(month_kw, hb=20002))
            ce.month_loop_chunk(None, keep, **dict(gauss_kw, tile0=i))
            for ops, kw in sobol_cases:
                ce.month_loop_chunk(*ops, **dict(kw, tile0=i))
            ce.law_chunk(law, **dict(law_kw, tile0=i))
            ce.law_chunk(law, **dict(law_kw, hb=4002))
            clt.clt_chunk(*clt_ops, **dict(clt_kw, tile0=i))
            histogram.histogram_counts(idx, 4096)
            for chunk, (ops, kw) in band_cases:
                chunk(*ops, **dict(kw, tile0=i))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The experiment probes: op-class toys, CLT ablation and grouping, byte
# planes
# ---------------------------------------------------------------------------

# the mm toy against its plain version: relative to a row's largest
# magnitude (tests/test_torch_clt_probes.py MM_ROW_REL: an accumulation-
# order ulp on a bf16 rounding edge moves an element by 2^-8)
MM_ROW_REL = 1e-3


@pytest.mark.parametrize("op", ["mul", "fma", "iadd", "shf", "cvt", "mm",
                                "hash"])
def test_op_toy_kernel_matches_plain(cuda, op):
    """The reports' 4096 tiles; bit for bit (fma too: -fmad=false rounds
    the product and the sum, as torch does), mm within MM_ROW_REL of its
    row's scale."""
    from stock_market_monte_carlo_torch.ops import calibration as cal

    n = cal.TOY_TILES
    got = cal.op_toy_chunk(op, n, device=cuda)
    want = cal.op_toy_chunk_plain(op, n, device=cuda)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n * 8, 128)
    if op == "mm":
        scale = want.abs().amax(dim=1, keepdim=True)
        assert bool(((got - want).abs() <= MM_ROW_REL * scale).all())
        assert bool(torch.isfinite(got).all())
    else:
        assert torch.equal(got, want)


def _probe_operands(cuda):
    arow, cs = clt.block_consts(np.float32(1.005), np.float32(1.0 / 120.0),
                                360)
    return (clt.q_tensor(cuda), torch.as_tensor(arow, device=cuda),
            torch.as_tensor(cs, device=cuda))


_PROBE_KW = dict(seed_base=99, tile0=5, valid=3 * 4096 + 1001,
                 n_paths=2 * 8192, v0=1000.0, target=6000.0, lo=300.0,
                 log_lo=float(np.log(300.0)),
                 inv_w=float(np.float32(4094 / np.log(1e3))), hb=4096,
                 with_hist=True, keep_finals=True)


@pytest.mark.parametrize("ablate", ["base", "nohist", "nologexp", "nodraw",
                                    "nomm"])
@pytest.mark.parametrize("tiles_per_block", [0, 2])
def test_clt_probe_kernel_matches_plain(cuda, ablate, tiles_per_block):
    """A ragged chunk at tile offset 5: finals within the CLT's kernel bar,
    counts and histogram but for finals near the target or a cell edge,
    min and max within the bar, power sums relative."""
    ops = _probe_operands(cuda)
    kw = dict(_PROBE_KW, ablate=ablate, tiles_per_block=tiles_per_block)
    sk, hk, fk = clt.clt_probe_chunk(*ops, **kw)
    sp, hp, fp = clt.clt_probe_chunk_plain(*ops, **kw)
    torch.cuda.synchronize()
    fk, fp = fk.cpu().numpy(), fp.cpu().numpy()
    np.testing.assert_allclose(fk, fp, rtol=CLT_KERNEL_REL, atol=0)
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    assert sk.dtype == np.float64 and sk[0] == sp[0]
    near = np.sum(np.abs(fp / 6000.0 - 1.0) <= CLT_KERNEL_REL)
    assert abs(sk[7] - sp[7]) <= near
    np.testing.assert_allclose(sk[[5, 6]], sp[[5, 6]], rtol=CLT_KERNEL_REL)
    np.testing.assert_allclose(sk[1:5], sp[1:5], rtol=1e-5)
    hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
    assert hk.sum() == hp.sum() == (0 if ablate == "nohist" else sk[0])
    assert np.abs(hk - hp).sum() <= 2 * np.sum(fk != fp)


@pytest.mark.parametrize("tiles_per_block", [1, 2, 4])
def test_clt_probe_groupings_are_bit_identical(cuda, tiles_per_block):
    """Streams are per tile: finals, histogram, count below, min and max
    equal at every grouping; the float64 power sums group the paths by
    block (1e-12). Each grouping counts under its own key."""
    ops = _probe_operands(cuda)
    kw = dict(_PROBE_KW, ablate="base", valid=5 * 4096 + 77,
              n_paths=3 * 8192)
    ce.reset_launch_counts()
    s0, h0, f0 = clt.clt_probe_chunk(*ops, tiles_per_block=0, **kw)
    s1, h1, f1 = clt.clt_probe_chunk(*ops, tiles_per_block=tiles_per_block,
                                     **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in ce.LAUNCHES.items() if v} == {
        "clt_probe_base": 1, f"clt_probe_ts{tiles_per_block}": 1}
    assert torch.equal(f0, f1) and torch.equal(h0, h1)
    assert torch.equal(s0[[0, 5, 6, 7]], s1[[0, 5, 6, 7]])
    rel = ((s1[1:5] - s0[1:5]).abs() / s0[1:5].abs()).max()
    assert float(rel) <= 1e-12


def test_byte_planes_kernel_matches_plain(cuda):
    """The 8 seeds of exp_prng_bytes.py and a seed past 2^31, bit for bit
    against the plain version and the counter word itself."""
    from stock_market_monte_carlo_torch.ops import byte_planes as bp

    seeds = list(bp.BYTES_SEEDS) + [(1 << 31) + 3]
    got = bp.byte_planes(seeds, device=cuda)
    want = bp.byte_planes_plain(seeds, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    w = ce._arith_bits((1 << 31) + 3, 0, torch.arange(bp.WORDS,
                                                      device=cuda))
    planes = got[-1].reshape(4, -1).long()
    for b in range(4):
        assert torch.equal(planes[b], (w >> (8 * b)) & 0xFF)


def test_probe_wrappers_check_inputs_and_count_launches(cuda):
    from stock_market_monte_carlo_torch.ops import byte_planes as bp
    from stock_market_monte_carlo_torch.ops import calibration as cal

    ops = _probe_operands(cuda)
    ce.reset_launch_counts()
    cal.op_toy_chunk_plain("mm", 2, device=cuda)
    clt.clt_probe_chunk_plain(*ops, ablate="base", **_PROBE_KW)
    bp.byte_planes_plain([1], device=cuda)
    assert sum(ce.LAUNCHES.values()) == 0
    cal.op_toy_chunk("mul", 2, device=cuda)
    clt.clt_probe_chunk(*ops, ablate="nomm", **_PROBE_KW)
    bp.byte_planes([1, 2], device=cuda)
    assert (ce.LAUNCHES["op_toy_mul"], ce.LAUNCHES["clt_probe_nomm"],
            ce.LAUNCHES["byte_planes"]) == (1, 1, 1)
    with pytest.raises(ValueError, match="op class"):
        cal.op_toy_chunk("div", 2, device=cuda)
    with pytest.raises(ValueError, match="in place"):
        clt.clt_probe_chunk(*ops, ablate="base", **dict(_PROBE_KW, hb=102))
    with pytest.raises(ValueError, match="ablation"):
        clt.clt_probe_chunk(*ops, ablate="nothing", **_PROBE_KW)
    with pytest.raises(TypeError):
        clt.clt_probe_chunk(ops[0].float(), *ops[1:], ablate="base",
                            **_PROBE_KW)
    assert sum(ce.LAUNCHES.values()) == 3


def test_op_toy_sass(cuda):
    """Each toy instance is found in the built library's SASS; mul issues
    at least one FMUL an element-pass, fma an FMUL and an FADD, mm its
    HMMAs (16 n-tiles x 8 k-steps a pass), and the chains are not folded
    away (a folded chain would cost about 1/12 of an instruction an
    element-pass). iadd's passes add their own addends on the integer
    pipe: IADD3, a three-input add, takes two passes' adds at once, so at
    least one IADD3 for two element-passes and no LEA or IMAD that adds
    x + 2ci (a few compute addresses)."""
    from stock_market_monte_carlo_torch.ops import calibration as cal

    sass = cal.op_toy_sass()
    chains = 12 * 16
    assert sass["mul"]["opcodes"].get("FMUL", 0) >= chains
    assert sass["fma"]["opcodes"].get("FADD", 0) >= chains
    assert sass["fma"]["opcodes"].get("FMUL", 0) >= chains
    assert sass["mm"]["opcodes"].get("HMMA", 0) == 16 * 8
    iadd = sass["iadd"]["opcodes"]
    assert iadd.get("IADD3", 0) >= chains // 2
    assert iadd.get("LEA", 0) + iadd.get("IMAD", 0) < 16
    for op, v in sass.items():
        assert v["per_element_pass"] >= 0.4, op
    prod = cal.clt_production_sass()
    assert sorted(prod) == [0, 1, 2] and min(prod.values()) > 100


# ---------------------------------------------------------------------------
# Long runs: bare launches that hold their outputs (ROADMAP queue 3, F4),
# and checkpoints written on the CPU resumed on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", held_outputs.CASES)
def test_launch_holds_its_outputs(cuda, case):
    """With its outputs closure dropped and a tensor of each output's size
    allocated, a bare launch writes its own outputs, as a launch that kept
    the closure did, and leaves the new tensors as they were."""
    ok, detail = held_outputs.check(case)
    assert ok, detail


class _Stop(Exception):
    pass


RESUME_SAMPLERS = {
    "historical": (smt.HistoricalBootstrap.from_csv, {}),
    "law": (smt.HistoricalBootstrap.from_csv, dict(terminal_law=True)),
    "icdf": (smt.GaussianReturns, {}),
    "clt": (smt.GaussianReturns, dict(gaussian_sampler="clt")),
}


@pytest.mark.parametrize("sampler", sorted(RESUME_SAMPLERS))
def test_cpu_checkpoint_resumes_on_the_card(cuda, tmp_path, sampler):
    """Two chunks checkpointed on the CPU, the rest on the card, against an
    uninterrupted card run. The historical draw is bit for bit on both
    devices, so its counts, min and max are exact; the card's log, log1p
    and exp differ from the CPU's in the last bit (ROADMAP queue 3), so
    the histograms are held as kernel against plain (cells within 2) and
    the other samplers' finals within CLT_KERNEL_REL; the power sums
    within 1e-6 (the CLT's within CLT_KERNEL_REL)."""
    make, extra = RESUME_SAMPLERS[sampler]
    model = make()
    n, t = 5 * 8192 + 321, 24
    kw = dict(seed=5, target_amount=1100.0)
    path = str(tmp_path / "run.npz")
    calls = []

    def stop(done, total):
        calls.append(done)
        if len(calls) == 2:
            raise _Stop()

    with pytest.raises(_Stop):
        smt.simulate_stats(model, n, t, checkpoint_path=path, progress=stop,
                           options=smt.EngineOptions(device="cpu",
                                                     chunk_paths=8192,
                                                     **extra), **kw)
    opts = smt.EngineOptions(chunk_paths=8192, **extra)
    resumed = smt.simulate_stats(model, n, t, checkpoint_path=path,
                                 options=opts, **kw)
    control = smt.simulate_stats(model, n, t, options=opts, **kw)
    got, want = resumed.moments, control.moments
    assert got.n == want.n == n
    hg, hw = resumed.histogram_counts, control.histogram_counts
    assert hg.sum() == hw.sum() == n
    assert np.abs(hg - hw).max() <= 2
    if sampler == "historical":
        assert (got.count_below, got.min, got.max) == (
            want.count_below, want.min, want.max)
    else:
        assert got.min == pytest.approx(want.min, rel=CLT_KERNEL_REL)
        assert got.max == pytest.approx(want.max, rel=CLT_KERNEL_REL)
        # only finals within CLT_KERNEL_REL of the target can move
        assert abs(got.count_below - want.count_below) <= np.abs(
            hg - hw).sum() + 2
    rel = CLT_KERNEL_REL if sampler == "clt" else 1e-6
    assert got.mean == pytest.approx(want.mean, rel=rel)
    assert got.std == pytest.approx(want.std, rel=rel)


@pytest.mark.parametrize("consumer", ["progress", "checkpoint"])
def test_simulate_stats_waits_for_one_chunk_at_a_time(cuda, tmp_path,
                                                      consumer):
    """With a per-chunk consumer (a progress callback, a checkpoint) the
    stats loop absorbs chunk i while chunk i+1 runs and waits for chunk
    i's copies alone (``engine.pinned_copy``); torch's sync debug mode
    "error" refuses a .cpu() of the stream, and is on from the first
    absorbed chunk to the last."""
    model = smt.HistoricalBootstrap.from_csv()
    n = 5 * 8192 + 77
    seen = []

    def progress(done, total):
        seen.append(done)
        torch.cuda.set_sync_debug_mode("error" if done < total
                                       else "default")

    kw = dict(seed=4, target_amount=1000.0,
              options=smt.EngineOptions(chunk_paths=8192))
    if consumer == "checkpoint":
        kw["checkpoint_path"] = str(tmp_path / "run.npz")
    try:
        got = smt.simulate_stats(model, n, 24, progress=progress, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert seen == [8192, 2 * 8192, 3 * 8192, 4 * 8192, 5 * 8192, n]
    want = smt.simulate_stats(model, n, 24, seed=4, target_amount=1000.0,
                              options=smt.EngineOptions(chunk_paths=8192))
    assert got.moments == want.moments
    np.testing.assert_array_equal(got.histogram_counts, want.histogram_counts)


# ---------------------------------------------------------------------------
# The paths mesh on the card (tests/test_torch_mesh.py's cases)
# ---------------------------------------------------------------------------


def _mesh_cases():
    import test_torch_mesh as tm

    return tm, sorted(tm.CASES)


def test_nccl_mesh_equals_single_device(cuda, tmp_path):
    """A 1-rank NCCL mesh (``paths_mesh(1)`` is the single-device path, so
    the test builds it): every case bit for bit against the single device;
    the mesh refuses another device than its own, and NCCL refuses the
    CPU."""
    import datetime

    import torch.distributed as dist

    from stock_market_monte_carlo_torch.parallel import PathsMesh

    tm, names = _mesh_cases()
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = PathsMesh(group=None, rank=0, size=1, backend="nccl",
                         device=torch.device("cuda",
                                             torch.cuda.current_device()))
        got = tm.split_cases(tm.run_cases(mesh, names, device="cuda"))
        with pytest.raises(ValueError, match="runs rank 0 on cuda"):
            smt.simulate_stats(smt.HistoricalBootstrap.from_csv(), 8192, 12,
                               options=smt.EngineOptions(device="cpu"),
                               mesh=mesh)
    finally:
        dist.destroy_process_group()
    want = tm.split_cases(tm.run_cases(None, names, device="cuda"))
    for name in names:
        tm.check_case(name, [got[name]], want[name])
    with pytest.raises(ValueError, match="NCCL paths mesh runs on the cards"):
        PathsMesh(group=None, rank=0, size=1, backend="nccl",
                  device=torch.device("cpu"))


def test_gloo_mesh_on_one_card(cuda):
    """Two gloo ranks in child processes, both on the card (the kernels run
    there, the exchange goes through the host): every case bit for bit
    against the single device."""
    from stock_market_monte_carlo_torch.parallel._ranks import run_ranks

    tm, names = _mesh_cases()
    ranks = [tm.split_cases(r) for r in run_ranks(
        2, "test_torch_mesh:run_cases", dict(names=names, device="cuda"),
        device="cuda", timeout=600.0)]
    want = tm.split_cases(tm.run_cases(None, names, device="cuda"))
    for name in names:
        tm.check_case(name, [r[name] for r in ranks], want[name])


# ---------------------------------------------------------------------------
# The user surfaces on the card.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,key,opts", [
    (["benchmark-mc-gpu", "1", "360", "20000000"], "month_loop", {}),
    (["benchmark-mc-reduceblock", "1", "360", "20000000", "--terminal-law"],
     "law", dict(terminal_law=True, histogram=False)),
])
def test_cli_runs_equal_direct_runs(cuda, capsys, monkeypatch, argv, key,
                                    opts):
    """The CLI on its default device launches only its kernel, and its
    result is a direct ``run`` with the CLI's arguments bit for bit."""
    from stock_market_monte_carlo_torch.cli.main import main

    calls = []
    real = smt.run
    monkeypatch.setattr(smt, "run", lambda *a, **k: calls.append(
        real(*a, **k)) or calls[-1])
    ce.reset_launch_counts()
    main(argv)
    torch.cuda.synchronize()
    counts = dict(ce.LAUNCHES)
    assert counts == dict({k: 0 for k in counts}, **{key: 2})
    (res,) = calls
    direct = real(smt.HistoricalBootstrap.from_csv(), 20_000_000, 360,
                  initial_capital=1000.0, seed=0, target_amount=1000.0,
                  options=smt.EngineOptions(**opts))
    assert res.moments == direct.moments
    if direct.histogram_counts is not None:
        np.testing.assert_array_equal(res.histogram_counts,
                                      direct.histogram_counts)
    out = capsys.readouterr().out
    assert f"mean: {direct.mean:.2f} | std: {direct.std:.2f}" in out


def test_native_build_matches_the_python_reader(cuda, tmp_path):
    """``native.build()`` with the card machine's g++, loaded through
    ``$SMMC_NATIVE_LIB``: the C++ reader equals the Python one."""
    import os

    from stock_market_monte_carlo_torch import native

    lib = native.build(out=tmp_path / "libsmmc_native.so")
    os.environ["SMMC_NATIVE_LIB"] = str(lib)
    native._LIB, native._LOAD_ATTEMPTED = None, False
    try:
        assert native.available()
        for path in (SYNTHETIC_CSV, HOSTILE_CSV):
            got = native.native_read_returns(path)
            native._LIB, native._LOAD_ATTEMPTED = None, True
            want = read_historical_returns(path)
            native._LIB, native._LOAD_ATTEMPTED = None, False
            np.testing.assert_array_equal(got, want)
    finally:
        del os.environ["SMMC_NATIVE_LIB"]
        native._LIB, native._LOAD_ATTEMPTED = None, False
