"""Sparse matrix containers and loaders.

Counterpart of the reference's IO layer
(graphlily/io/data_loader.h:19-157): CSR/CSC containers, a scipy-npz loader,
csr<->csc conversion, and dtype conversion. Containers are plain numpy (host
preprocessing); device layouts are produced by `graphlily_jax.io.formatter`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row. Reference: graphlily/io/data_loader.h:19-30."""

    num_rows: int
    num_cols: int
    adj_data: np.ndarray     # (nnz,)
    adj_indices: np.ndarray  # (nnz,) column index per nnz
    adj_indptr: np.ndarray   # (num_rows+1,)

    @property
    def nnz(self) -> int:
        return int(self.adj_indptr[-1])

    def copy(self) -> "CSRMatrix":
        return CSRMatrix(self.num_rows, self.num_cols, self.adj_data.copy(),
                         self.adj_indices.copy(), self.adj_indptr.copy())

    def row_ids(self) -> np.ndarray:
        """Expand indptr to a per-nnz row-id array (COO rows)."""
        return np.repeat(
            np.arange(self.num_rows, dtype=np.int64),
            np.diff(self.adj_indptr.astype(np.int64)),
        )

    def todense(self) -> np.ndarray:
        d = np.zeros((self.num_rows, self.num_cols), dtype=self.adj_data.dtype)
        rows = self.row_ids()
        np.add.at(d, (rows, self.adj_indices[: self.nnz].astype(np.int64)),
                  self.adj_data[: self.nnz])
        return d


@dataclasses.dataclass
class CSCMatrix:
    """Compressed sparse column. Reference: graphlily/io/data_loader.h:93-104."""

    num_rows: int
    num_cols: int
    adj_data: np.ndarray
    adj_indices: np.ndarray  # row index per nnz
    adj_indptr: np.ndarray   # (num_cols+1,)

    @property
    def nnz(self) -> int:
        return int(self.adj_indptr[-1])

    def copy(self) -> "CSCMatrix":
        return CSCMatrix(self.num_rows, self.num_cols, self.adj_data.copy(),
                         self.adj_indices.copy(), self.adj_indptr.copy())


def csr_from_coo(rows, cols, vals, num_rows, num_cols) -> CSRMatrix:
    """Build CSR from COO triplets (sorted stably by row)."""
    rows = np.asarray(rows)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], np.asarray(cols)[order], np.asarray(vals)[order]
    indptr = np.zeros(num_rows + 1, dtype=np.uint32)
    counts = np.bincount(rows, minlength=num_rows)  # np.add.at is ~1M op/s
    indptr[1:] = np.cumsum(counts, dtype=np.uint64).astype(np.uint32)
    return CSRMatrix(num_rows, num_cols, vals, cols.astype(np.uint32), indptr)


def load_csr_matrix_from_float_npz(path) -> CSRMatrix:
    """Load a scipy-saved CSR npz (float32).

    Reference: graphlily/io/data_loader.h:51-70. Accepts both scipy>=1.8 key
    conventions ('indices'/'indptr'/'data'/'shape') and the reference's raw
    reader behavior.
    """
    f = np.load(path, allow_pickle=False)
    data = f["data"].astype(np.float32)
    indices = f["indices"].astype(np.uint32)
    indptr = f["indptr"].astype(np.uint32)
    shape = f["shape"]
    num_rows, num_cols = int(shape[0]), int(shape[-1])
    return CSRMatrix(num_rows, num_cols, data, indices, indptr)


def save_csr_matrix_to_float_npz(csr: CSRMatrix, path) -> None:
    """Save in the scipy csr_matrix npz layout (what scipy.sparse.save_npz emits,
    and what tests/test_data/create_csr.py:14-16 produces in the reference)."""
    np.savez(
        path,
        data=csr.adj_data.astype(np.float32),
        indices=csr.adj_indices.astype(np.int32),
        indptr=csr.adj_indptr.astype(np.int32),
        shape=np.asarray([csr.num_rows, csr.num_cols]),
        format=np.bytes_(b"csr"),
    )


def csr2csc(csr: CSRMatrix) -> CSCMatrix:
    """Transpose storage order. Reference: graphlily/io/data_loader.h:109-144.

    Vectorized counting-sort over columns (the reference uses the same
    counting-sort algorithm with explicit loops).
    """
    nnz = csr.nnz
    cols = csr.adj_indices[:nnz].astype(np.int64)
    rows = csr.row_ids()[:nnz]
    indptr = np.zeros(csr.num_cols + 1, dtype=np.int64)
    indptr[1:] = np.bincount(cols, minlength=csr.num_cols)
    indptr = np.cumsum(indptr)
    order = np.argsort(cols, kind="stable")  # stable keeps rows ascending per col
    return CSCMatrix(
        num_rows=csr.num_rows,
        num_cols=csr.num_cols,
        adj_data=csr.adj_data[:nnz][order].copy(),
        adj_indices=rows[order].astype(np.uint32),
        adj_indptr=indptr.astype(np.uint32),
    )


def csc2csr(csc: CSCMatrix) -> CSRMatrix:
    """Inverse of csr2csc."""
    nnz = csc.nnz
    rows = csc.adj_indices[:nnz].astype(np.int64)
    cols = np.repeat(np.arange(csc.num_cols, dtype=np.int64),
                     np.diff(csc.adj_indptr.astype(np.int64)))
    indptr = np.zeros(csc.num_rows + 1, dtype=np.int64)
    indptr[1:] = np.bincount(rows, minlength=csc.num_rows)
    indptr = np.cumsum(indptr)
    order = np.argsort(rows, kind="stable")
    return CSRMatrix(
        num_rows=csc.num_rows,
        num_cols=csc.num_cols,
        adj_data=csc.adj_data[:nnz][order].copy(),
        adj_indices=cols[order].astype(np.uint32),
        adj_indptr=indptr.astype(np.uint32),
    )


def csr_matrix_convert_from_float(csr: CSRMatrix, dtype) -> CSRMatrix:
    """Dtype conversion. Reference: graphlily/io/data_loader.h:76-84."""
    out = csr.copy()
    out.adj_data = out.adj_data.astype(dtype)
    return out
