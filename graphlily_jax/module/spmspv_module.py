"""SpMSpV module.

Counterpart of the reference's SpMSpVModule (graphlily/module/spmspv_module.h):
CSC-formatted matrix, sparse frontier vector in/out with an nnz header
(on-device scalar here), dense mask, masked semiring SpMSpV.

Engine: the dense-frontier product over the CSC-ordered COO twin
(ops/reference.py `coo_product`). It reads every edge whatever the
frontier's size: the reference's input-sparsity exploitation (dynamic burst
reads, hw/kernel_spmspv_impl.h:100-120) has no counterpart yet, and the
adaptive push/pull apps switch on frontier density exactly as the
reference does (app/bfs.h:190).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import (MaskType, OpType, FLOAT_INF,
                        apply_mask_sparse_style, ufixed_quantize)
from ..io.matrix import CSCMatrix
from ..ops.reference import COODevice, coo_from_csc, coo_product
from ..ops.vector import (SparseVector, sparse_from_entries,
                          sparse_to_dense, dense_to_sparse)
from .base import BaseModule, DeviceBuffer


class SpMSpVModule(BaseModule):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG,
                 out_buf_len: int | None = None):
        super().__init__(config)
        del out_buf_len  # parity arg (spmspv_module.h ctor)
        self.csc_matrix_: Optional[CSCMatrix] = None
        self.vector_buf = DeviceBuffer()   # SparseVector
        self.mask_buf = DeviceBuffer()     # dense
        self.results_buf = DeviceBuffer()  # SparseVector
        self._coo: Optional[COODevice] = None
        self.num_rows_ = 0
        self.num_cols_ = 0

    def load_and_format_matrix(self, csc_matrix: CSCMatrix) -> None:
        assert self.semiring_ is not None, "set_semiring before formatting"
        self.csc_matrix_ = csc_matrix.copy()
        self.num_rows_ = csc_matrix.num_rows
        self.num_cols_ = csc_matrix.num_cols
        self._coo = coo_from_csc(csc_matrix, dtype=self.config.jdtype)

    def send_matrix_host_to_device(self) -> None:
        return None

    def get_num_rows(self) -> int:
        return self.num_rows_

    def get_num_cols(self) -> int:
        return self.num_cols_

    def get_nnz(self) -> int:
        return self.csc_matrix_.nnz if self.csc_matrix_ is not None else 0

    @property
    def capacity(self) -> int:
        return self.config.frontier_capacity or self.num_rows_

    # ---- vectors ---------------------------------------------------------
    def send_vector_host_to_device(self, sv) -> None:
        """Accepts a SparseVector or (indices, values) host pair."""
        if isinstance(sv, SparseVector):
            self.vector_buf.value = sv
        else:
            idx, vals = sv
            self.vector_buf.value = sparse_from_entries(
                idx, vals, self.capacity, dtype=self.config.jdtype)

    def send_mask_host_to_device(self, mask) -> None:
        self.mask_buf.value = jnp.asarray(
            np.asarray(mask, dtype=self.config.dtype))

    def send_mask_device_to_host(self) -> np.ndarray:
        return np.asarray(self.mask_buf.value)

    def send_results_device_to_host(self) -> SparseVector:
        return self.results_buf.value

    def get_results_nnz(self) -> int:
        """Reference: the 1-element D2D readback of results[0].index
        (spmspv_module.h:239-242). Host-sync version; fused app loops keep
        this scalar on device instead."""
        return int(self.results_buf.value.nnz)

    def bind_vector_buf(self, buf: DeviceBuffer) -> None:
        self.vector_buf = buf

    def bind_mask_buf(self, buf: DeviceBuffer) -> None:
        self.mask_buf = buf

    # ---- execution -------------------------------------------------------
    def device_state(self) -> COODevice:
        return self._coo

    def apply_dense(self, x, mask=None, state: COODevice | None = None):
        """Dense-frontier flavor for fused app loops: takes/returns dense
        vectors (inactive = semiring zero), skipping the per-iteration
        sparse<->dense conversions. Returns (y_dense, nnz) with nnz an
        on-device scalar — the reference's get_results_nnz readback
        (spmspv_module.h:239-242) without the host sync."""
        zero = self.semiring_.zero
        coo = state if state is not None else self._coo
        y = coo_product(coo, x, self.semiring_, rows_sorted=False)
        if mask is not None and self.mask_type_ != MaskType.NO_MASK:
            y = apply_mask_sparse_style(y, mask, self.mask_type_, zero)
        if (self.config.simulate_ufixed
                and self.semiring_.op == OpType.MULADD):
            y = ufixed_quantize(y)   # before the nnz count: sub-grid values
            # round to 0 and drop out of the frontier, as on the bitstream
        nnz = jnp.sum(y != jnp.asarray(zero, y.dtype)).astype(jnp.int32)
        return y, nnz

    def apply(self, sv: SparseVector, mask: jax.Array | None = None,
              state: COODevice | None = None
              ) -> tuple[SparseVector, jax.Array]:
        """Sparse API: (sparse results, dense results), a conversion
        around `apply_dense`."""
        zero = self.semiring_.zero
        x = sparse_to_dense(sv, self.num_cols_, zero)
        y, _ = self.apply_dense(x, mask, state=state)
        return dense_to_sparse(y, zero, self.capacity), y

    def run(self) -> None:
        mask = self.mask_buf.value if self.mask_type_ != MaskType.NO_MASK else None
        sv_out, _dense = self.apply(self.vector_buf.value, mask)
        self.results_buf.value = sv_out

    # ---- CPU oracle ------------------------------------------------------
    def compute_reference_results(self, sparse_vector, mask=None) -> np.ndarray:
        """Dense float oracle; reference: spmspv_module.h:446-520.
        `sparse_vector` is (indices, values) host arrays or a SparseVector."""
        if isinstance(sparse_vector, SparseVector):
            n = int(sparse_vector.nnz)
            idx = np.asarray(sparse_vector.indices[:n])
            val = np.asarray(sparse_vector.values[:n], np.float64)
        else:
            idx = np.asarray(sparse_vector[0])
            val = np.asarray(sparse_vector[1], np.float64)
        csc = self.csc_matrix_
        y = np.full(self.num_rows_, self.semiring_.zero, np.float64)
        for vecv, c in zip(val, idx):
            lo, hi = csc.adj_indptr[c], csc.adj_indptr[c + 1]
            rr = csc.adj_indices[lo:hi].astype(np.int64)
            mm = csc.adj_data[lo:hi].astype(np.float64)
            if self.semiring_.op == OpType.MULADD:
                np.add.at(y, rr, mm * vecv)
            elif self.semiring_.op == OpType.ANDOR:
                c2 = np.logical_and(mm != 0, vecv != 0).astype(np.float64)
                y[rr] = np.logical_or(y[rr] != 0, c2 != 0).astype(np.float64)
            else:
                incr = np.minimum(mm + vecv, float(FLOAT_INF))
                np.minimum.at(y, rr, incr)
        if mask is not None and self.mask_type_ != MaskType.NO_MASK:
            m = np.asarray(mask, np.float64)
            zero = self.semiring_.zero
            if self.mask_type_ == MaskType.WRITE_TO_ONE:
                y[m == zero] = zero
            else:
                y[m != zero] = zero
        return y
