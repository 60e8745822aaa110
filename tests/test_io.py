"""IO layer tests — counterpart of the reference's tests/test_io.cpp:
loader round-trips, csr<->csc, dimension rounding, outdegree normalization,
row reordering, SSSP self-edge preprocessing, and the device COO format.
"""
import numpy as np
import pytest

from graphlily_jax.io import (CSRMatrix, csr_from_coo, csr2csc, csc2csr,
                              load_csr_matrix_from_float_npz,
                              save_csr_matrix_to_float_npz,
                              util_round_csr_matrix_dim,
                              util_normalize_csr_matrix_by_outdegree,
                              util_reorder_rows_ascending_nnz,
                              add_self_edges_for_sssp,
                              uniform_csr, dense_csr, conflict_csr, rmat_csr)
from graphlily_jax.ops import coo_from_csr, coo_from_csc


def small_fixture():
    # 4x4 hand matrix:
    # [[1 0 2 0]
    #  [0 0 0 0]
    #  [3 0 0 4]
    #  [0 5 0 0]]
    rows = [0, 0, 2, 2, 3]
    cols = [0, 2, 0, 3, 1]
    vals = [1.0, 2.0, 3.0, 4.0, 5.0]
    return csr_from_coo(rows, cols, vals, 4, 4)


def test_csr_from_coo_dense():
    csr = small_fixture()
    d = csr.todense()
    want = np.array([[1, 0, 2, 0], [0, 0, 0, 0], [3, 0, 0, 4], [0, 5, 0, 0]],
                    dtype=np.float32)
    np.testing.assert_array_equal(d, want)
    assert csr.nnz == 5
    np.testing.assert_array_equal(csr.adj_indptr, [0, 2, 2, 4, 5])


def test_npz_roundtrip(tmp_path):
    csr = small_fixture()
    p = tmp_path / "m.npz"
    save_csr_matrix_to_float_npz(csr, p)
    back = load_csr_matrix_from_float_npz(p)
    np.testing.assert_array_equal(back.todense(), csr.todense())


def test_npz_scipy_compat(tmp_path):
    scipy = pytest.importorskip("scipy")
    import scipy.sparse as sp
    m = sp.random(13, 7, density=0.3, format="csr", dtype=np.float32,
                  random_state=0)
    p = tmp_path / "s.npz"
    sp.save_npz(p, m)
    back = load_csr_matrix_from_float_npz(p)
    np.testing.assert_allclose(back.todense(), m.toarray())


def test_csr2csc_roundtrip():
    csr = small_fixture()
    csc = csr2csc(csr)
    np.testing.assert_array_equal(csc.adj_indptr, [0, 2, 3, 4, 5])
    # column-major data of the fixture: col0=(1,3), col1=(5), col2=(2), col3=(4)
    np.testing.assert_array_equal(csc.adj_data, [1, 3, 5, 2, 4])
    np.testing.assert_array_equal(csc.adj_indices, [0, 2, 3, 0, 2])
    back = csc2csr(csc)
    np.testing.assert_array_equal(back.todense(), csr.todense())


def test_csr2csc_random(rng):
    csr = uniform_csr(64, 48, 5, seed=3)
    csc = csr2csc(csr)
    d1 = csr.todense()
    d2 = np.zeros_like(d1)
    for c in range(csc.num_cols):
        for k in range(csc.adj_indptr[c], csc.adj_indptr[c + 1]):
            d2[csc.adj_indices[k], c] += csc.adj_data[k]
    np.testing.assert_allclose(d1, d2)


def test_round_dim():
    csr = small_fixture()
    util_round_csr_matrix_dim(csr, 8, 16)
    assert csr.num_rows == 8 and csr.num_cols == 16
    assert len(csr.adj_indptr) == 9
    assert csr.adj_indptr[-1] == csr.adj_indptr[4] == 5  # padded rows empty
    # no-op when already divisible
    util_round_csr_matrix_dim(csr, 8, 16)
    assert csr.num_rows == 8 and csr.num_cols == 16


def test_normalize_by_outdegree():
    csr = small_fixture()
    util_normalize_csr_matrix_by_outdegree(csr)
    d = csr.todense()
    # column counts: col0 has 2 nnz, col1 1, col2 1, col3 1
    np.testing.assert_allclose(d[0, 0], 0.5)
    np.testing.assert_allclose(d[2, 0], 0.5)
    np.testing.assert_allclose(d[3, 1], 1.0)
    np.testing.assert_allclose(d[0, 2], 1.0)
    np.testing.assert_allclose(d[2, 3], 1.0)


def test_reorder_rows_ascending_nnz():
    csr = small_fixture()
    reordered, perm = util_reorder_rows_ascending_nnz(csr)
    counts = np.diff(reordered.adj_indptr)
    assert (np.diff(counts) >= 0).all()
    # permuting back reproduces the matrix
    dense = reordered.todense()
    orig = csr.todense()
    np.testing.assert_array_equal(dense, orig[perm])


def test_sssp_self_edges():
    csr = small_fixture()
    out = add_self_edges_for_sssp(csr)
    d = out.todense()
    for i in range(4):
        assert d[i, i] == 0.0
    # off-diagonal entries preserved
    orig = csr.todense()
    off = ~np.eye(4, dtype=bool)
    np.testing.assert_array_equal(d[off], orig[off])
    # row 1 was empty -> got exactly one (self) entry
    assert out.adj_indptr[2] - out.adj_indptr[1] == 1


@pytest.mark.parametrize("maker,kw", [
    (uniform_csr, dict(num_rows=1000, num_cols=1000, degree=7, seed=1)),
    (dense_csr, dict(num_rows=96, num_cols=96)),
    (conflict_csr, dict(num_rows=500, num_cols=1500)),
    (rmat_csr, dict(num_rows=2000, nnz=30000, seed=2)),
])
def test_coo_device_format_lossless(maker, kw):
    """The device COO of both the CSR and the CSC twin is a lossless
    encoding; padding entries point at row num_rows with value 0."""
    csr = maker(**kw)
    for coo in (coo_from_csr(csr), coo_from_csc(csr2csc(csr))):
        assert (coo.num_rows, coo.num_cols, coo.nnz) == (
            csr.num_rows, csr.num_cols, csr.nnz)
        rows, cols = np.asarray(coo.rows), np.asarray(coo.cols)
        vals = np.asarray(coo.vals, np.float64)
        assert len(rows) % 8 == 0
        assert (rows[coo.nnz:] == csr.num_rows).all()
        assert (vals[coo.nnz:] == 0).all()
        dense = np.zeros((csr.num_rows + 1, csr.num_cols), np.float64)
        np.add.at(dense, (rows, cols), vals)
        np.testing.assert_allclose(dense[:csr.num_rows], csr.todense(),
                                   rtol=1e-6)


def test_coo_from_csr_rows_sorted():
    """spmv_coo tells the segment reduce its rows are sorted: CSR order
    must hold, padding included."""
    csr = uniform_csr(2000, 2000, 5, seed=4)
    rows = np.asarray(coo_from_csr(csr).rows)
    assert (np.diff(rows) >= 0).all()
