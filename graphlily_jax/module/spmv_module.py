"""SpMV module.

Counterpart of the reference's SpMVModule (graphlily/module/spmv_module.h):
owns the formatted matrix, the vector/mask/results buffers, a `run()` that
executes one masked semiring SpMV on device, and a float CPU oracle.

The device format is the row-sorted COO of `coo_from_csr`, and the product
is `spmv_coo` (ops/reference.py) on every platform.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import MaskType, OpType, FLOAT_INF
from ..io.matrix import CSRMatrix
from ..io.formatter import util_round_csr_matrix_dim
from ..ops.reference import COODevice, coo_from_csr, spmv_coo
from .base import BaseModule, DeviceBuffer


class SpMVModule(BaseModule):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG,
                 num_channels: int | None = None,
                 out_buf_len: int | None = None,
                 vec_buf_len: int | None = None):
        """`num_channels`/`out_buf_len`/`vec_buf_len` accepted for reference
        API parity (module/spmv_module.h:95-102); the COO engine has no
        geometry to set."""
        super().__init__(config)
        del num_channels, out_buf_len, vec_buf_len
        self.csr_matrix_: Optional[CSRMatrix] = None
        self.vector_buf = DeviceBuffer()
        self.mask_buf = DeviceBuffer()
        self.results_buf = DeviceBuffer()
        self._coo: Optional[COODevice] = None
        self.num_rows_ = 0
        self.num_cols_ = 0

    # ---- matrix ----------------------------------------------------------
    def load_and_format_matrix(self, csr_matrix: CSRMatrix,
                               skip_empty_rows: bool | None = None) -> None:
        """Round both dims up to multiples of 1024 and ship the row-sorted
        COO. `skip_empty_rows` is accepted for parity: COO has no
        end-of-row markers, so empty rows cost nothing."""
        assert self.semiring_ is not None, "set_semiring before formatting"
        work = util_round_csr_matrix_dim(csr_matrix.copy(), 1024, 1024)
        self.csr_matrix_ = work
        self._coo = coo_from_csr(work, dtype=self.config.jdtype)
        self.num_rows_, self.num_cols_ = work.num_rows, work.num_cols

    def send_matrix_host_to_device(self) -> None:
        """Parity no-op: formatting already produced device arrays."""
        return None

    def get_num_rows(self) -> int:
        return self.num_rows_

    def get_num_cols(self) -> int:
        return self.num_cols_

    def get_nnz(self) -> int:
        return self.csr_matrix_.nnz if self.csr_matrix_ is not None else 0

    # ---- vectors ---------------------------------------------------------
    def _to_dense_device(self, v) -> jax.Array:
        v = np.asarray(v, dtype=self.config.dtype)
        if len(v) < self.num_rows_:
            pad = np.zeros(self.num_rows_ - len(v), v.dtype)
            v = np.concatenate([v, pad])
        return jnp.asarray(v)

    def send_vector_host_to_device(self, vector) -> None:
        assert len(vector) <= self.num_cols_
        v = np.asarray(vector, dtype=self.config.dtype)
        if len(v) < self.num_cols_:
            fill = np.full(self.num_cols_ - len(v),
                           self.semiring_.zero if self.semiring_ else 0,
                           v.dtype)
            v = np.concatenate([v, fill])
        self.vector_buf.value = jnp.asarray(v)

    def send_mask_host_to_device(self, mask) -> None:
        self.mask_buf.value = self._to_dense_device(mask)

    def send_vector_device_to_host(self) -> np.ndarray:
        return np.asarray(self.vector_buf.value)

    def send_mask_device_to_host(self) -> np.ndarray:
        return np.asarray(self.mask_buf.value)

    def send_results_device_to_host(self) -> np.ndarray:
        return np.asarray(self.results_buf.value)

    def bind_vector_buf(self, buf: DeviceBuffer) -> None:
        self.vector_buf = buf

    def bind_mask_buf(self, buf: DeviceBuffer) -> None:
        self.mask_buf = buf

    # ---- execution -------------------------------------------------------
    def device_state(self) -> COODevice:
        """Matrix arrays as a pytree — pass this through jit boundaries and
        hand it back via `apply(..., state=)` so large operands are arguments,
        not HLO constants."""
        return self._coo

    def apply(self, x: jax.Array, mask: jax.Array | None = None,
              state: COODevice | None = None) -> jax.Array:
        """Functional core: y = mask(A (x) x). Jittable."""
        coo = state if state is not None else self._coo
        y = spmv_coo(coo, x, self.semiring_, mask, self.mask_type_)
        if self.config.simulate_ufixed and self.semiring_.op == OpType.MULADD:
            # bit-parity experiment mode: saturate/round to the reference's
            # ap_ufixed<32,8,AP_RND,AP_SAT> grid (graphlily/global.h:63)
            from ..semiring import ufixed_quantize
            y = ufixed_quantize(y)
        return y

    def run(self) -> None:
        mask = self.mask_buf.value if self.mask_type_ != MaskType.NO_MASK else None
        self.results_buf.value = self.apply(self.vector_buf.value, mask)

    # ---- CPU oracle ------------------------------------------------------
    def compute_reference_results(self, vector, mask=None) -> np.ndarray:
        """Float CPU oracle; reference: module/spmv_module.h:488-532."""
        csr = self.csr_matrix_
        nnz = csr.nnz
        rows = csr.row_ids()
        cols = csr.adj_indices[:nnz].astype(np.int64)
        vals = csr.adj_data[:nnz].astype(np.float64)
        x = np.asarray(vector, np.float64)
        y = np.full(self.num_rows_, self.semiring_.zero, np.float64)
        contrib_x = x[cols]
        if self.semiring_.op == OpType.MULADD:
            np.add.at(y, rows, vals * contrib_x)
        elif self.semiring_.op == OpType.ANDOR:
            c = np.logical_and(vals != 0, contrib_x != 0).astype(np.float64)
            np.add.at(y, rows, c)
            y = (y != 0).astype(np.float64)
        else:
            c = np.minimum(vals + contrib_x, float(FLOAT_INF))
            np.minimum.at(y, rows, c)
        if mask is not None and self.mask_type_ != MaskType.NO_MASK:
            m = np.asarray(mask)
            if self.mask_type_ == MaskType.WRITE_TO_ZERO:
                y[m[: self.num_rows_] != 0] = 0
            else:
                y[m[: self.num_rows_] == 0] = 0
        return y
