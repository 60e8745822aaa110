"""Matrix formatting: host-side preprocessing of CSR matrices.

Counterpart of the reference's data formatter (graphlily/io/data_formatter.h).
The reference builds CPSR — HBM-channel-packed streams of rows with IDX_MARKER
row terminators — for a 16-channel x 8-PE dataflow overlay. The device
format here is plain COO (ops/reference.py `coo_from_csr`/`coo_from_csc`),
so what remains are the reference's host utilities: dimension rounding,
outdegree normalisation, row reordering (data_formatter.h:19-33, 37-51,
330-360), vertex relabeling and the SSSP self-edge preprocessing.
"""
from __future__ import annotations

import numpy as np

from .matrix import CSRMatrix


# --------------------------------------------------------------------------
# Host-side CSR utilities (parity with reference data_formatter utils)
# --------------------------------------------------------------------------

def util_round_csr_matrix_dim(csr: CSRMatrix, row_divisor: int, col_divisor: int) -> CSRMatrix:
    """Pad rows/cols up to divisors (in place, returns csr).

    Reference: graphlily/io/data_formatter.h:19-33 — padded rows are empty,
    padded cols are just a num_cols bump.
    """
    if csr.num_rows % row_divisor != 0:
        pad = row_divisor - csr.num_rows % row_divisor
        csr.adj_indptr = np.concatenate(
            [csr.adj_indptr,
             np.full(pad, csr.adj_indptr[csr.num_rows], dtype=csr.adj_indptr.dtype)])
        csr.num_rows += pad
    if csr.num_cols % col_divisor != 0:
        csr.num_cols += col_divisor - csr.num_cols % col_divisor
    return csr


def util_normalize_csr_matrix_by_outdegree(csr: CSRMatrix) -> CSRMatrix:
    """Set data[i] = 1 / (#nnz in that column). Reference: data_formatter.h:37-51.

    (For a graph adjacency where A[dst,src]=edge, column count = outdegree.)
    """
    cols = csr.adj_indices[: csr.nnz].astype(np.int64)
    nnz_each_col = np.bincount(cols, minlength=csr.num_cols)
    with np.errstate(divide="ignore"):
        inv = 1.0 / nnz_each_col
    csr.adj_data = inv[cols].astype(csr.adj_data.dtype)
    return csr


def util_reorder_rows_ascending_nnz(csr: CSRMatrix):
    """Sort rows by ascending nnz; returns (reordered_csr, row_perm).

    row_perm[i] = original row id now at position i.
    Reference: graphlily/io/data_formatter.h:330-360 (built + tested there,
    unused by modules; here it is the SELL-sigma-style balance lever).
    """
    counts = np.diff(csr.adj_indptr.astype(np.int64))
    perm = np.argsort(counts, kind="stable")
    return permute_rows(csr, perm), perm


def permute_rows(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Return CSR with rows reordered so new row i = old row perm[i]."""
    counts = np.diff(csr.adj_indptr.astype(np.int64))
    new_counts = counts[perm]
    new_indptr = np.zeros(csr.num_rows + 1, dtype=np.int64)
    np.cumsum(new_counts, out=new_indptr[1:])
    nnz = csr.nnz
    starts = csr.adj_indptr[:-1].astype(np.int64)[perm]
    # gather each row's slice
    idx = np.repeat(starts - new_indptr[:-1], new_counts) + np.arange(nnz)
    return CSRMatrix(csr.num_rows, csr.num_cols,
                     csr.adj_data[idx], csr.adj_indices[idx],
                     new_indptr.astype(np.uint32))


def symmetric_permute(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Relabel vertices: new id i = old id perm[i]; A'[i,j] = A[perm[i],perm[j]].

    Graph algorithms are invariant under vertex relabeling, so apps can run
    entirely in the relabeled space (translate the source going in, un-permute
    the result coming out) — no per-iteration permutation cost."""
    assert csr.num_rows == csr.num_cols
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    nnz = csr.nnz
    rows = inv[csr.row_ids()]
    cols = inv[csr.adj_indices[:nnz].astype(np.int64)]
    if csr.num_cols <= (1 << 32):
        # composite-key argsort is ~3x np.lexsort at 30M+ nnz on this host
        # (21.9 s -> 7.5 s measured) — this sort dominates graph prep time
        order = np.argsort((rows.astype(np.uint64) << 32)
                           | cols.astype(np.uint64), kind="stable")
    else:
        order = np.lexsort((cols, rows))
    indptr = np.zeros(csr.num_rows + 1, np.int64)
    indptr[1:] = np.bincount(rows, minlength=csr.num_rows)
    return CSRMatrix(csr.num_rows, csr.num_cols, csr.adj_data[order],
                     cols[order].astype(np.uint32),
                     np.cumsum(indptr).astype(np.uint32))


def degree_sort_permutation(csr: CSRMatrix) -> np.ndarray:
    """Vertices by descending (in+out) degree. Clusters power-law hubs at
    low vertex ids (a relabeling counterpart of the reference's
    load-balance lever, util_reorder_rows_ascending_nnz)."""
    # bincount, NOT np.add.at: add.at is far slower on 100M+-edge graphs
    deg = (np.bincount(csr.row_ids(), minlength=csr.num_rows)
           + np.bincount(csr.adj_indices[: csr.nnz].astype(np.int64),
                         minlength=csr.num_rows)[:csr.num_rows])
    return np.argsort(-deg, kind="stable")


def add_self_edges_for_sssp(csr: CSRMatrix) -> CSRMatrix:
    """Insert zero-weight self edges (and zero existing diagonals).

    Reference SSSP preprocessing: graphlily/app/sssp.h:16-62. Vectorized:
    zero any existing diagonal entries, then insert missing ones.
    """
    n = min(csr.num_rows, csr.num_cols)
    nnz = csr.nnz
    rows = csr.row_ids()
    cols = csr.adj_indices[:nnz].astype(np.int64)
    data = csr.adj_data[:nnz].astype(np.float32).copy()
    diag = rows == cols
    data[diag] = 0.0
    have_diag = np.zeros(csr.num_rows, dtype=bool)
    have_diag[rows[diag]] = True
    missing = np.nonzero(~have_diag[:n])[0]
    all_rows = np.concatenate([rows, missing])
    all_cols = np.concatenate([cols, missing])
    all_data = np.concatenate([data, np.zeros(len(missing), np.float32)])
    # stable sort by (row, col) to keep deterministic layout
    order = np.lexsort((all_cols, all_rows))
    all_rows, all_cols, all_data = all_rows[order], all_cols[order], all_data[order]
    indptr = np.zeros(csr.num_rows + 1, dtype=np.int64)
    indptr[1:] = np.bincount(all_rows, minlength=csr.num_rows)
    indptr = np.cumsum(indptr)
    return CSRMatrix(csr.num_rows, csr.num_cols, all_data,
                     all_cols.astype(np.uint32), indptr.astype(np.uint32))
