"""Ops layer tests: XLA reference engine vs numpy oracles, all semirings x masks.

Mirrors the reference's module-level test matrix
(tests/test_module_spmv_spmspv.cpp:137-178: {semirings} x {masks} x {datasets}
x {vector sparsities}) and tests/test_module_apply.cpp.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphlily_jax import (ArithmeticSemiring, LogicalSemiring, TropicalSemiring,
                           MaskType, FLOAT_INF)
from graphlily_jax.io import (uniform_csr, dense_csr, conflict_csr, csr2csc)
from graphlily_jax.ops import (coo_from_csr, coo_from_csc, spmv_coo, spmspv_coo,
                               sparse_from_entries, sparse_to_dense,
                               dense_to_sparse, ewise_add_scalar,
                               assign_vector_dense,
                               assign_vector_sparse_no_new_frontier,
                               assign_vector_sparse_new_frontier, SparseVector)

SEMIRINGS = [ArithmeticSemiring, LogicalSemiring, TropicalSemiring]
MASKS = [MaskType.NO_MASK, MaskType.WRITE_TO_ZERO, MaskType.WRITE_TO_ONE]


# ---------------- numpy oracles (transcribed from the reference CPU refs) ----

def np_spmv(csr, x, semiring):
    """graphlily/module/spmv_module.h:488-510 semantics."""
    y = np.full(csr.num_rows, semiring.zero, dtype=np.float64)
    for row in range(csr.num_rows):
        for k in range(csr.adj_indptr[row], csr.adj_indptr[row + 1]):
            col = csr.adj_indices[k]
            v = csr.adj_data[k]
            if semiring.name == "arithmetic":
                y[row] += v * x[col]
            elif semiring.name == "logical":
                y[row] = float(bool(y[row]) or (bool(v) and bool(x[col])))
            else:
                y[row] = min(y[row], min(v + x[col], FLOAT_INF))
    return y


def np_mask_spmv(y, mask, mask_type):
    """graphlily/module/spmv_module.h:515-532: literal-0 compare and fill."""
    y = y.copy()
    if mask_type == MaskType.WRITE_TO_ZERO:
        y[mask != 0] = 0
    elif mask_type == MaskType.WRITE_TO_ONE:
        y[mask == 0] = 0
    return y


def np_mask_spmspv(y, mask, mask_type, zero):
    """graphlily/module/spmspv_module.h:500-517: semiring-zero compare/fill."""
    y = y.copy()
    if mask_type == MaskType.WRITE_TO_ONE:
        y[mask == zero] = zero
    elif mask_type == MaskType.WRITE_TO_ZERO:
        y[mask != zero] = zero
    return y


def make_x(num_cols, semiring, sparsity, rng):
    """Dense vector with given zero-fraction; inactive = semiring.zero."""
    x = rng.random(num_cols).astype(np.float32) + 0.5
    inactive = rng.random(num_cols) < sparsity
    x[inactive] = semiring.zero
    return x


# ---------------- SpMV ------------------------------------------------------

@pytest.mark.parametrize("semiring", SEMIRINGS, ids=lambda s: s.name)
@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
def test_spmv_xla_engine(semiring, mask_type, rng):
    csr = uniform_csr(200, 200, 6, seed=7)
    coo = coo_from_csr(csr)
    x = make_x(200, semiring, 0.3, rng)
    mask = (rng.random(200) < 0.5).astype(np.float32)
    y = np.asarray(spmv_coo(coo, jnp.asarray(x), semiring,
                            jnp.asarray(mask), mask_type))
    want = np_mask_spmv(np_spmv(csr, x, semiring), mask, mask_type)
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("maker,kw", [
    (dense_csr, dict(num_rows=64, num_cols=64)),
    (conflict_csr, dict(num_rows=300, num_cols=600)),
])
def test_spmv_xla_shapes(maker, kw, rng):
    csr = maker(**kw)
    coo = coo_from_csr(csr)
    x = rng.random(csr.num_cols).astype(np.float32)
    y = np.asarray(spmv_coo(coo, jnp.asarray(x), ArithmeticSemiring))
    np.testing.assert_allclose(y, csr.todense().astype(np.float64) @ x,
                               rtol=1e-4)


# ---------------- SpMSpV ----------------------------------------------------

@pytest.mark.parametrize("semiring", SEMIRINGS, ids=lambda s: s.name)
@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.99])
def test_spmspv_xla_engine(semiring, mask_type, sparsity, rng):
    csr = uniform_csr(150, 150, 5, seed=11)
    csc = csr2csc(csr)
    coo = coo_from_csc(csc)
    nnz_vec = max(1, int(150 * (1 - sparsity)))
    idx = rng.choice(150, size=nnz_vec, replace=False)
    vals = rng.random(nnz_vec).astype(np.float32) + 0.5
    sv = sparse_from_entries(np.sort(idx), vals[np.argsort(idx)], capacity=256)
    mask = (rng.random(150) * 2).astype(np.float32)
    mask[rng.random(150) < 0.5] = semiring.zero
    sv_out, y_dense = spmspv_coo(coo, sv, semiring, jnp.asarray(mask), mask_type)
    # oracle: dense x then csr spmv then spmspv-style mask
    x = np.full(150, semiring.zero, np.float32)
    x[np.asarray(sv.indices[:nnz_vec])] = np.asarray(sv.values[:nnz_vec])
    want = np_mask_spmspv(np_spmv(csr, x, semiring), mask, mask_type, semiring.zero)
    np.testing.assert_allclose(np.asarray(y_dense), want, rtol=1e-5, atol=1e-5)
    # sparse result consistency
    back = np.asarray(sparse_to_dense(sv_out, 150, semiring.zero))
    np.testing.assert_allclose(back, want, rtol=1e-5, atol=1e-5)


def test_sparse_vector_roundtrip(rng):
    dense = rng.random(64).astype(np.float32)
    dense[rng.random(64) < 0.6] = 0.0
    sv = dense_to_sparse(jnp.asarray(dense), 0.0)
    assert int(sv.nnz) == (dense != 0).sum()
    back = np.asarray(sparse_to_dense(sv, 64, 0.0))
    np.testing.assert_array_equal(back, dense)


# ---------------- apply ops -------------------------------------------------

def test_ewise_add(rng):
    x = rng.random(100).astype(np.float32)
    out = np.asarray(ewise_add_scalar(jnp.asarray(x), 2.5))
    np.testing.assert_allclose(out, x + 2.5, rtol=1e-6)
    # val=0 is the on-device copy idiom (app/bfs.h:122)
    np.testing.assert_array_equal(np.asarray(ewise_add_scalar(jnp.asarray(x), 0.0)), x)


def test_ewise_add_prefix_length(rng):
    """The reference kernel touches exactly `len` elements
    (add_scalar_vector_dense_module.h:150-189): adding to a prefix of a
    padded vector must leave the tail unchanged."""
    x = rng.random(100).astype(np.float32)
    out = np.asarray(ewise_add_scalar(jnp.asarray(x), 2.5, length=60))
    np.testing.assert_allclose(out[:60], x[:60] + 2.5, rtol=1e-6)
    np.testing.assert_array_equal(out[60:], x[60:])


def test_dense_to_sparse_capacity_clamp():
    """nnz must never exceed the compaction capacity (jnp.nonzero truncates
    silently); downstream scatters trust nnz."""
    dense = jnp.asarray(np.arange(1, 33, dtype=np.float32))  # 32 nonzeros
    sv = dense_to_sparse(dense, 0.0, capacity=8)
    assert int(sv.nnz) == 8
    np.testing.assert_array_equal(np.asarray(sv.indices), np.arange(8))


@pytest.mark.parametrize("mask_type", [MaskType.WRITE_TO_ZERO, MaskType.WRITE_TO_ONE])
def test_assign_dense(mask_type, rng):
    inout = rng.random(80).astype(np.float32)
    mask = (rng.random(80) < 0.5).astype(np.float32)
    out = np.asarray(assign_vector_dense(jnp.asarray(inout), jnp.asarray(mask),
                                         9.0, mask_type))
    want = inout.copy()
    if mask_type == MaskType.WRITE_TO_ZERO:
        want[mask == 0] = 9.0
    else:
        want[mask != 0] = 9.0
    np.testing.assert_array_equal(out, want)


def test_assign_dense_requires_mask():
    with pytest.raises(ValueError):
        assign_vector_dense(jnp.zeros(8), jnp.zeros(8), 1.0, MaskType.NO_MASK)


def test_assign_sparse_no_new_frontier(rng):
    inout = rng.random(50).astype(np.float32)
    sv = sparse_from_entries([3, 17, 44], [1.0, 1.0, 1.0], capacity=8)
    out = np.asarray(assign_vector_sparse_no_new_frontier(
        jnp.asarray(inout), sv, 7.0))
    want = inout.copy()
    want[[3, 17, 44]] = 7.0
    np.testing.assert_array_equal(out, want)
    # padding entries beyond nnz must not write
    sv2 = SparseVector(sv.indices, sv.values, jnp.asarray(1, jnp.int32))
    out2 = np.asarray(assign_vector_sparse_no_new_frontier(
        jnp.asarray(inout), sv2, 7.0))
    want2 = inout.copy()
    want2[3] = 7.0
    np.testing.assert_array_equal(out2, want2)


def test_assign_sparse_new_frontier(rng):
    inout = np.array([5.0, 1.0, 9.0, 4.0, 2.0], np.float32)
    sv = sparse_from_entries([0, 1, 2, 4], [3.0, 2.0, 9.5, 1.0], capacity=8)
    new_inout, nf = assign_vector_sparse_new_frontier(jnp.asarray(inout), sv)
    # improved: idx0 (5>3), idx2? 9>9.5 no, idx4 (2>1); idx1 (1>2 no)
    np.testing.assert_array_equal(np.asarray(new_inout),
                                  [3.0, 1.0, 9.0, 4.0, 1.0])
    assert int(nf.nnz) == 2
    got = {(int(nf.indices[k]), float(nf.values[k])) for k in range(2)}
    assert got == {(0, 3.0), (4, 1.0)}
