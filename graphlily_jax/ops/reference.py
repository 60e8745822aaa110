"""The engine: jittable jnp implementations of all six operations.

These are the device counterparts of the reference modules'
`compute_reference_results` CPU oracles (graphlily/module/spmv_module.h:478-532,
spmspv_module.h:444-520, add_scalar_vector_dense_module.h:195-204,
assign_vector_dense_module.h:223-246, assign_vector_sparse_module.h:306-335),
and the device path the modules run.

SpMV is a gather of x by column plus a segment reduce by row over COO
arrays: `take` then `segment_sum`/`segment_min`. XLA lowers the gather to
native loads and the segment reduce to a scatter with atomics, so the
product is bound by memory traffic (~12 B per edge) and atomic throughput,
not by arithmetic. On a GPU the row-sorted product runs a Triton kernel
instead (ops/spmv_triton.py), which cuts the atomics to one per row run.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..semiring import (Semiring, MaskType, OpType, apply_mask,
                        apply_mask_sparse_style)
from .spmv_triton import spmv_triton
from .vector import SparseVector, sparse_to_dense, dense_to_sparse


@jax.tree_util.register_pytree_node_class
class COODevice:
    """Device-resident COO (padding uses row=num_rows, which the segment
    reduce drops).

    Registered as a pytree with static geometry so it can be passed THROUGH
    jit boundaries as an argument: a multi-GB matrix captured as a closure
    constant would be embedded in the compiled program."""

    def __init__(self, rows, cols, vals, num_rows, num_cols, nnz):
        self.rows = rows    # (nnz_padded,) int32
        self.cols = cols    # (nnz_padded,) int32
        self.vals = vals    # (nnz_padded,)
        self.num_rows = int(num_rows)
        self.num_cols = int(num_cols)
        self.nnz = int(nnz)

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), (self.num_rows,
                                                   self.num_cols, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def coo_from_csr(csr, dtype=jnp.float32, pad_to_multiple: int = 8) -> COODevice:
    nnz = csr.nnz
    pad = (-nnz) % pad_to_multiple
    rows = np.concatenate([csr.row_ids(), np.full(pad, csr.num_rows, np.int64)])
    cols = np.concatenate([csr.adj_indices[:nnz].astype(np.int64), np.zeros(pad, np.int64)])
    vals = np.concatenate([csr.adj_data[:nnz], np.zeros(pad, csr.adj_data.dtype)])
    return COODevice(jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
                     jnp.asarray(vals, dtype), csr.num_rows, csr.num_cols, nnz)


def coo_from_csc(csc, dtype=jnp.float32, pad_to_multiple: int = 8) -> COODevice:
    """COO from CSC (kept col-major; rows array holds row ids)."""
    nnz = csc.nnz
    pad = (-nnz) % pad_to_multiple
    cols = np.repeat(np.arange(csc.num_cols, dtype=np.int64),
                     np.diff(csc.adj_indptr.astype(np.int64)))
    rows = np.concatenate([csc.adj_indices[:nnz].astype(np.int64),
                           np.full(pad, csc.num_rows, np.int64)])
    cols = np.concatenate([cols, np.zeros(pad, np.int64)])
    vals = np.concatenate([csc.adj_data[:nnz], np.zeros(pad, csc.adj_data.dtype)])
    return COODevice(jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
                     jnp.asarray(vals, dtype), csc.num_rows, csc.num_cols, nnz)


def _segment_combine(semiring: Semiring, contrib, rows, num_rows, indices_are_sorted):
    if semiring.op == OpType.MULADD:
        return jax.ops.segment_sum(contrib, rows, num_segments=num_rows,
                                   indices_are_sorted=indices_are_sorted)
    if semiring.op == OpType.ANDOR:
        s = jax.ops.segment_sum(contrib, rows, num_segments=num_rows,
                                indices_are_sorted=indices_are_sorted)
        return jnp.where(s != 0, jnp.ones_like(s), jnp.zeros_like(s))
    if semiring.op == OpType.ADDMIN:
        m = jax.ops.segment_min(contrib, rows, num_segments=num_rows,
                                indices_are_sorted=indices_are_sorted)
        # empty segments come back as +inf from segment_min; clamp to zero elt
        return jnp.minimum(m, jnp.asarray(semiring.zero, dtype=m.dtype))
    raise ValueError(semiring.op)


def coo_product(coo: COODevice, x: jax.Array, semiring: Semiring,
                rows_sorted: bool) -> jax.Array:
    """Unmasked y = A (x) x over the semiring for a dense x. `rows_sorted`
    says whether `coo.rows` is ascending (CSR order). A row-sorted product
    lowered for a CUDA device runs the Triton kernel of ops/spmv_triton.py,
    which reduces row runs before its atomics and measured faster end to
    end (PERF.md); every other product, and every other platform, is XLA's
    gather + segment reduce. The choice follows the platform the
    computation is lowered for, not the process's default backend."""
    if not rows_sorted:
        return xla_product(coo, x, semiring, rows_sorted)
    return jax.lax.platform_dependent(
        coo, x, cuda=lambda c, v: spmv_triton(c, v, semiring),
        default=lambda c, v: xla_product(c, v, semiring, True))


def xla_product(coo: COODevice, x: jax.Array, semiring: Semiring,
                rows_sorted: bool) -> jax.Array:
    """`coo_product` as XLA's gather of x by column, multiply, and segment
    reduce by row (one atomic per edge on a GPU); sorted rows let XLA
    skip a sort."""
    xg = jnp.take(x, coo.cols, fill_value=semiring.zero)
    contrib = semiring.mul(coo.vals, xg)
    return _segment_combine(semiring, contrib, coo.rows, coo.num_rows,
                            rows_sorted)


def spmv_coo(coo: COODevice, x: jax.Array, semiring: Semiring,
             mask: jax.Array | None = None,
             mask_type: MaskType = MaskType.NO_MASK) -> jax.Array:
    """y = mask( A (x) x ) over the semiring on row-sorted COO; exact
    reference semantics (graphlily/module/spmv_module.h:488-532)."""
    y = coo_product(coo, x, semiring, rows_sorted=True)
    if mask is not None and mask_type != MaskType.NO_MASK:
        y = apply_mask(y, mask, mask_type, semiring.zero)
    return y


def spmspv_coo(coo_csc: COODevice, sv: SparseVector, semiring: Semiring,
               mask: jax.Array | None = None,
               mask_type: MaskType = MaskType.NO_MASK,
               capacity: int | None = None) -> tuple[SparseVector, jax.Array]:
    """Sparse-vector SpMV: returns (sparse results, dense results).

    Dense-frontier emulation: scatter the frontier to a dense vector filled
    with the semiring zero; the zero annihilates inactive columns for all
    three semirings, so semantics match the active-columns-only reference
    oracle (graphlily/module/spmspv_module.h:446-520). Masking uses the
    SpMSpV flavor (semiring-zero comparisons, :500-517). The product reads
    every edge, whatever the frontier's size.
    """
    x = sparse_to_dense(sv, coo_csc.num_cols, semiring.zero)
    y = coo_product(coo_csc, x, semiring, rows_sorted=False)
    if mask is not None and mask_type != MaskType.NO_MASK:
        y = apply_mask_sparse_style(y, mask, mask_type, semiring.zero)
    cap = capacity or coo_csc.num_rows
    return dense_to_sparse(y, semiring.zero, cap), y


def ewise_add_scalar(x: jax.Array, val, length: int | None = None) -> jax.Array:
    """out[i] = in[i] + val for i < length, unchanged beyond (plain add
    regardless of semiring; used with val=0 as the on-device copy). The
    reference kernel applies the op to exactly `len` elements
    (graphlily/hw/kernel_add_scalar_vector_dense_impl.h:17-26,
    module/add_scalar_vector_dense_module.h:150-189); `length=None` means the
    whole vector."""
    y = x + jnp.asarray(val, dtype=x.dtype)
    if length is None:
        return y
    return jnp.where(jnp.arange(x.shape[0]) < length, y, x)


def assign_vector_dense(inout: jax.Array, mask: jax.Array, val,
                        mask_type: MaskType) -> jax.Array:
    """Masked dense assign: WRITE_TO_ZERO -> where mask==0 set val;
    WRITE_TO_ONE -> where mask!=0 set val. Reference:
    graphlily/hw/kernel_assign_vector_dense_impl.h:22-46."""
    v = jnp.asarray(val, dtype=inout.dtype)
    if mask_type == MaskType.WRITE_TO_ZERO:
        return jnp.where(mask == 0, v, inout)
    if mask_type == MaskType.WRITE_TO_ONE:
        return jnp.where(mask != 0, v, inout)
    raise ValueError("assign_vector_dense requires a mask type "
                     "(reference exits on NO_MASK, assign_vector_dense_module.h:88-95)")


def assign_vector_sparse_no_new_frontier(inout: jax.Array, mask: SparseVector,
                                         val) -> jax.Array:
    """inout[mask.indices[k]] = val for k < mask.nnz. Reference:
    graphlily/hw/kernel_assign_vector_sparse_no_new_frontier_impl.h:18-54."""
    k = jnp.arange(mask.capacity)
    idx = jnp.where(k < mask.nnz, mask.indices, inout.shape[0])
    v = jnp.full(mask.capacity, jnp.asarray(val, inout.dtype))
    return inout.at[idx].set(v, mode="drop")


def assign_vector_sparse_new_frontier(inout: jax.Array, mask: SparseVector,
                                      capacity: int | None = None
                                      ) -> tuple[jax.Array, SparseVector]:
    """Relaxation with frontier generation: for each (idx, val) in the mask,
    if inout[idx] > val then inout[idx] = val and (idx, val) joins the new
    frontier. Returns (new inout, new frontier).

    Reference: graphlily/hw/kernel_assign_vector_sparse_new_frontier_impl.h:15-77.
    Assumes mask indices are unique (true for SpMSpV results, the only producer
    in the reference apps, graphlily/app/sssp.h:185-191).
    """
    cap = capacity or mask.capacity
    k = jnp.arange(mask.capacity)
    active = k < mask.nnz
    idx_safe = jnp.where(active, mask.indices, inout.shape[0])
    cur = jnp.take(inout, idx_safe, fill_value=0.0)
    improved = jnp.logical_and(active, cur > mask.values)
    new_inout = inout.at[jnp.where(improved, mask.indices, inout.shape[0])
                         ].min(mask.values, mode="drop")
    # compact improved entries into the new frontier (ascending position order,
    # matching the reference's in-order batch appends)
    nnz = jnp.sum(improved).astype(jnp.int32)
    (pos,) = jnp.nonzero(improved, size=cap, fill_value=mask.capacity - 1)
    nf = SparseVector(indices=mask.indices[pos], values=mask.values[pos], nnz=nnz)
    return new_inout, nf
