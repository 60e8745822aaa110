"""SpMV engines vs an independent float64 numpy oracle.

Counterpart of the reference's hardware-unit testbenches
(tests/test_pe_cluster.cpp, tests/test_shuffle.cpp): each product — XLA's
`spmv_coo` and the Triton kernel in interpret mode — is driven directly,
across semirings and masks, on shapes that stress it: empty rows and row
windows, dimensions that are not multiples of 1024, a dense block, the
adversarial conflict fixture (all columns collide mod 128) and a hub row.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphlily_jax import (ArithmeticSemiring, LogicalSemiring,
                           TropicalSemiring, MaskType, FLOAT_INF)
from graphlily_jax.io import (uniform_csr, dense_csr, conflict_csr, rmat_csr,
                              csr_from_coo, util_round_csr_matrix_dim)
from graphlily_jax.ops import coo_from_csr, spmv_coo
from graphlily_jax.ops import reference
from graphlily_jax.ops.spmv_triton import spmv_triton
from graphlily_jax.semiring import OpType, apply_mask

SEMIRINGS = [ArithmeticSemiring, LogicalSemiring, TropicalSemiring]


def triton_interpret(coo, x, semiring, mask, mask_type):
    y = spmv_triton(coo, x, semiring, interpret=True)
    return apply_mask(y, mask, mask_type, semiring.zero)


ENGINES = {"xla": spmv_coo, "triton": triton_interpret}
engines = pytest.mark.parametrize("engine", list(ENGINES))


def assert_close(engine, y, want):
    """One tolerance for every engine: each sums a row's own entries."""
    del engine
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


def oracle(csr, x, semiring, mask, mask_type):
    rows = csr.row_ids()
    cols = csr.adj_indices[:csr.nnz].astype(np.int64)
    vals = csr.adj_data[:csr.nnz].astype(np.float64)
    xg = np.asarray(x, np.float64)[cols]
    if semiring.op == OpType.MULADD:
        y = np.bincount(rows, vals * xg, minlength=csr.num_rows)
    elif semiring.op == OpType.ANDOR:
        hit = ((vals != 0) & (xg != 0)).astype(np.float64)
        y = (np.bincount(rows, hit, minlength=csr.num_rows) != 0) * 1.0
    else:
        y = np.full(csr.num_rows, float(FLOAT_INF))
        np.minimum.at(y, rows, np.minimum(vals + xg, float(FLOAT_INF)))
    if mask_type == MaskType.WRITE_TO_ZERO:
        y[mask != 0] = 0
    elif mask_type == MaskType.WRITE_TO_ONE:
        y[mask == 0] = 0
    return y


def run(engine, csr, semiring, mask_type, rng):
    csr = util_round_csr_matrix_dim(csr.copy(), 1024, 1024)
    x = (rng.random(csr.num_cols) + 0.5).astype(np.float32)
    x[rng.random(csr.num_cols) < 0.3] = semiring.zero
    mask = (rng.random(csr.num_rows) < 0.5).astype(np.float32)
    y = np.asarray(ENGINES[engine](coo_from_csr(csr), jnp.asarray(x),
                                   semiring, jnp.asarray(mask), mask_type))
    return y, oracle(csr, x, semiring, mask, mask_type)


@engines
@pytest.mark.parametrize("semiring", SEMIRINGS, ids=lambda s: s.name)
@pytest.mark.parametrize("mask_type",
                         [MaskType.NO_MASK, MaskType.WRITE_TO_ZERO,
                          MaskType.WRITE_TO_ONE], ids=lambda m: m.name)
def test_spmv_semirings_masks(engine, semiring, mask_type, rng):
    csr = uniform_csr(1500, 1500, 4, seed=21)
    y, want = run(engine, csr, semiring, mask_type, rng)
    assert_close(engine, y, want)


@engines
@pytest.mark.parametrize("maker,kw", [
    (dense_csr, dict(num_rows=256, num_cols=256)),
    (conflict_csr, dict(num_rows=1024, num_cols=2048)),
    (rmat_csr, dict(num_rows=3000, nnz=40000, seed=5)),
    (uniform_csr, dict(num_rows=900, num_cols=2100, degree=3, seed=6)),
], ids=["dense", "conflict", "rmat", "uniform_nonsquare"])
def test_spmv_shapes(engine, maker, kw, rng):
    y, want = run(engine, maker(**kw), ArithmeticSemiring, MaskType.NO_MASK,
                  rng)
    assert_close(engine, y, want)


@engines
def test_spmv_empty_windows(engine, rng):
    """Only the first 100 of 4096 rows have nnz: the rest must be 0."""
    csr = uniform_csr(100, 3000, 4, seed=9)
    util_round_csr_matrix_dim(csr, 4096, 1024)
    y, want = run(engine, csr, ArithmeticSemiring, MaskType.NO_MASK, rng)
    assert_close(engine, y, want)
    assert (y[100:] == 0).all()


@engines
def test_spmv_tropical_empty_rows(engine, rng):
    """Empty rows must produce the tropical zero (INF), not garbage."""
    csr = uniform_csr(64, 1024, 3, seed=10)
    y, want = run(engine, csr, TropicalSemiring, MaskType.NO_MASK, rng)
    np.testing.assert_allclose(y, want, rtol=1e-6)
    assert (y[64:] == FLOAT_INF).all()


@engines
def test_spmv_tropical_conflict(engine, rng):
    """Every column collides mod 128 and rows are long."""
    csr = conflict_csr(num_rows=1024, num_cols=2048)
    y, want = run(engine, csr, TropicalSemiring, MaskType.NO_MASK, rng)
    np.testing.assert_allclose(y, want, rtol=1e-6)


@engines
def test_spmv_tropical_hub_rows(engine, rng):
    """One hub row with 700 nnz amid singleton rows."""
    rng2 = np.random.default_rng(3)
    rows = np.concatenate([np.zeros(700, np.int64),
                           np.arange(1, 300, dtype=np.int64)])
    cols = rng2.integers(0, 1024, 999)
    csr = csr_from_coo(rows, cols, rng2.random(999).astype(np.float32),
                       1024, 1024)
    y, want = run(engine, csr, TropicalSemiring, MaskType.NO_MASK, rng)
    np.testing.assert_allclose(y, want, rtol=1e-6)


@engines
def test_spmv_signed_wide_range_per_row(engine):
    """Signed values over ten decades, with a hub row's large entries in
    the same blocks as small rows and a row that cancels: every row's error
    is bounded by its own contributions, sum_j |a_ij x_j|, whatever its
    neighbours hold."""
    rng = np.random.default_rng(12)
    deg = np.concatenate([[1500], rng.integers(1, 5, 600), [3], [700]])
    rows = np.repeat(np.arange(len(deg)), deg)
    sign = np.where(rng.random(len(rows)) < 0.5, -1.0, 1.0)
    mag = 10.0 ** rng.uniform(-6, 4, len(rows))
    vals = (sign * mag).astype(np.float32)
    start = deg[:-2].sum()                  # the cancelling row
    vals[start:start + 3] = [1024.0, -1024.0, 2.0 ** -10]   # exact sums
    cols = rng.integers(0, 2048, len(rows))
    csr = csr_from_coo(rows, cols, vals, 2048, 2048)
    x = ((rng.random(2048) + 0.5)
         * np.where(rng.random(2048) < 0.5, -1, 1)).astype(np.float32)
    x[cols[start:start + 3]] = 1.0
    y = np.asarray(ENGINES[engine](coo_from_csr(csr), jnp.asarray(x),
                                   ArithmeticSemiring, None,
                                   MaskType.NO_MASK), np.float64)
    prod = csr.adj_data[:csr.nnz].astype(np.float64) * x[
        csr.adj_indices[:csr.nnz]]
    want = np.bincount(csr.row_ids(), prod, minlength=2048)
    own = np.bincount(csr.row_ids(), np.abs(prod), minlength=2048)
    err = np.abs(y - want)
    assert (err <= 1e-5 * own).all(), float(np.max(err / np.maximum(own,
                                                                    1e-30)))
    assert y[len(deg) - 2] == 2.0 ** -10


@pytest.mark.parametrize("semiring", SEMIRINGS, ids=lambda s: s.name)
def test_product_choice_follows_lowering_platform(semiring):
    """A row-sorted product lowered for CUDA runs the Triton kernel (which
    must lower to Triton IR for every semiring); lowered for the CPU, or in
    CSC order, it is XLA's product. The host needs no GPU to lower."""
    coo = coo_from_csr(uniform_csr(64, 64, 2, seed=1))
    x = jnp.ones(64)

    def kernels(rows_sorted, platform):
        traced = jax.jit(lambda c, v: reference.coo_product(
            c, v, semiring, rows_sorted)).trace(coo, x)
        text = traced.lower(lowering_platforms=(platform,)).as_text()
        return text.count("__gpu$xla.gpu.triton")

    assert kernels(True, "cuda") == 1
    assert kernels(True, "cpu") == 0
    assert kernels(False, "cuda") == 0
