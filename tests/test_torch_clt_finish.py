"""The CLT kernel's finish (``csrc/clt.cu``, plain and keep-fold variants
and the probe instances) in its CPU twin, ``clt.finish_sum_twin``, against
the plain version's column-by-column sum (``clt_chunk_plain``).

The kernel finishes a path's row in the tensor cores' accumulator layout:
lane tig of a quad adds the logs of its columns nt*8 + 2*tig + e (nt =
0..15, e = 0, 1) in that order, and two xor shuffles add the quad's four
partial sums as (p0 + p1) + (p2 + p3). The plain version adds the 128
logs in column order. On the stream's own rows (2^16 paths x 360 months
of ``_growth_blocks``, each variant) the two finals stay within the
kernel-against-plain bar, 1e-5. On adversarial rows (columns whose
product is near 0, beside large logs) the difference is what float32
summation gives any two orders: both sums lie within the recursive
summation bound of the exact (float64) sum, and the twin's order is the
closer of the two. The card test holds the kernel to this twin bit for
bit (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401

from stock_market_monte_carlo_torch.ops import clt
from stock_market_monte_carlo_torch.ops import cuda_engine as ce

PATHS = 1 << 16
MONTHS = 360
# the kernel-against-plain bar (tests/test_torch_gpu.py CLT_KERNEL_REL)
CLT_KERNEL_REL = 1e-5
U = 2.0 ** -24


def _sequential(terms):
    acc = torch.zeros_like(terms[:, 0])
    for c in range(clt.CLT_K):
        acc = acc + terms[:, c]
    return acc


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs()).max())


def test_twin_order_is_the_kernel_layout():
    """Each thread's 32 columns, over the quad's four lanes, are every
    column once; a table whose columns are distinct powers of two sums
    exactly in any order, so the twin is the row sum there."""
    cols = [nt * 8 + 2 * tig + e for tig in range(4)
            for nt in range(16) for e in range(2)]
    assert sorted(cols) == list(range(128))
    terms = torch.as_tensor(np.ldexp(1.0, np.arange(-64, 64)).astype(
        np.float32))[None, :]
    assert torch.equal(clt.finish_sum_twin(terms),
                       terms.double().sum(1).float())


@pytest.mark.parametrize("variant,ablate", [("plain", "base"),
                                            ("keep_fold", "base"),
                                            ("plain", "nologexp")])
def test_twin_finals_within_the_bar_of_plain(variant, ablate, capsys):
    a, b = ce.gaussian_ab(0.5, 10.0 / 12)
    keep = np.random.default_rng(6).uniform(0.995, 1.0, MONTHS).astype(
        np.float32)
    arow, cs = (torch.as_tensor(x) for x in clt.block_consts(
        a, b, MONTHS, keep if variant == "keep_fold" else None))
    q = clt.q_tensor("cpu")
    seed_base = 0x9E3779B9 ^ clt.CLT_STREAM_XOR
    kw = dict(seed_base=seed_base, tile0=37, valid=PATHS, n_paths=PATHS,
              v0=1000.0, target=1000.0, lo=300.0,
              log_lo=float(np.log(300.0)),
              inv_w=float(np.float32(4094 / np.log(10.0))), hb=4096,
              with_hist=False, keep_finals=True)
    if ablate == "base":
        plain = clt.clt_chunk_plain(q, arow, cs, None, variant=variant,
                                    shift=1.0, **kw)[2]
    else:
        plain = clt.clt_probe_chunk_plain(q, arow, cs, ablate=ablate,
                                          **kw)[2]
    prod = clt.row_products(q, arow, cs, seed_base=seed_base, tile0=37,
                            rows=torch.arange(PATHS), ablate=ablate)
    twin = clt.finals_twin(prod, 1000.0, ablate)
    r = _rel(twin, plain)
    with capsys.disabled():
        print(f"\nCLT finish twin vs plain, {variant} {ablate}, {PATHS} x "
              f"{MONTHS}: max rel {r!r}, {int((twin != plain).sum())} of "
              f"{PATHS} finals differ")
    assert r <= CLT_KERNEL_REL


def _adversarial_rows(n_extreme, n=4096):
    """(n, 128) float32 column products: the stream's spread around 1,
    with ``n_extreme`` random columns near 0 (1e-6: log -13.8) and as many
    large ones (8: log 2.08), each row's logs summing to what a finite,
    positive final holds."""
    rng = np.random.default_rng(n_extreme)
    logs = rng.normal(0.015, 0.08, (n, 128))
    for row in logs:
        cols = rng.permutation(128)
        row[cols[:n_extreme]] = -13.8 + rng.normal(0.0, 0.01, n_extreme)
        row[cols[n_extreme:2 * n_extreme]] = 2.08 + rng.normal(
            0.0, 0.01, n_extreme)
    return torch.as_tensor(np.exp(logs).astype(np.float32))


@pytest.mark.parametrize("n_extreme", [1, 2, 4, 6])
def test_twin_order_at_adversarial_rows(n_extreme, capsys):
    """Both orders within the recursive-summation bound of the exact sum
    (127 u sum |log| for 128 terms, u = 2^-24); the twin's order no
    farther from it than the plain's; the finals' largest relative
    difference reported."""
    logs = torch.log(_adversarial_rows(n_extreme))
    exact = logs.double().sum(1)
    bound = 127 * U * logs.double().abs().sum(1) / (1 - 127 * U)
    seq, twin = _sequential(logs), clt.finish_sum_twin(logs)
    err_seq = (seq.double() - exact).abs()
    err_twin = (twin.double() - exact).abs()
    assert bool((err_seq <= bound).all()) and bool((err_twin <= bound).all())
    assert float(err_twin.max()) <= float(err_seq.max())
    f_seq = 1000.0 * torch.exp(seq)
    f_twin = 1000.0 * torch.exp(twin)
    assert bool(torch.isfinite(f_seq).all()) and bool((f_seq > 0).all())
    r = _rel(f_twin, f_seq)
    with capsys.disabled():
        print(f"\nCLT finish twin vs plain order, {n_extreme} columns near 0 "
              f"and {n_extreme} large a row: finals max rel {r!r}; sum "
              f"errors vs float64 twin {float(err_twin.max())!r}, plain "
              f"{float(err_seq.max())!r}")
