"""Sparse vector representation.

The reference encodes sparse vectors as packed arrays whose element 0 is a
header with `index = nnz` (graphlily/global.h:152-164). The JAX
representation is a static-capacity struct-of-arrays pytree — XLA needs static
shapes, so capacity is fixed and `nnz` is a traced scalar (the on-device
counterpart of the reference's `get_results_nnz()` D2D readback,
graphlily/module/spmspv_module.h:239-242 — here it stays on device inside
`lax.while_loop` carries).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SparseVector(NamedTuple):
    indices: jax.Array  # (capacity,) int32; entries >= nnz are padding
    values: jax.Array   # (capacity,)
    nnz: jax.Array      # () int32

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]


def sparse_from_entries(indices, values, capacity: int, dtype=jnp.float32) -> SparseVector:
    """Build from host entry lists (pads to capacity)."""
    indices = np.asarray(indices, dtype=np.int32)
    values = np.asarray(values)
    n = len(indices)
    assert n <= capacity
    idx = np.zeros(capacity, np.int32)
    val = np.zeros(capacity, dtype)
    idx[:n] = indices
    val[:n] = values
    return SparseVector(jnp.asarray(idx), jnp.asarray(val, dtype=dtype),
                        jnp.asarray(n, jnp.int32))


def sparse_to_dense(sv: SparseVector, size: int, zero) -> jax.Array:
    """Scatter to dense, inactive = `zero` (reference:
    graphlily/global.h:152-164 convert_sparse_vec_to_dense_vec)."""
    k = jnp.arange(sv.capacity)
    active = k < sv.nnz
    # route padding writes to an out-of-range index so they are dropped
    idx = jnp.where(active, sv.indices, size)
    dense = jnp.full(size, zero, dtype=sv.values.dtype)
    return dense.at[idx].set(sv.values, mode="drop")


def dense_to_sparse(dense: jax.Array, zero, capacity: int | None = None) -> SparseVector:
    """Compact nonzero (!= zero) entries, ascending index, static capacity."""
    if capacity is None:
        capacity = dense.shape[0]
    m = dense != jnp.asarray(zero, dtype=dense.dtype)
    # jnp.nonzero(size=capacity) silently truncates to the first `capacity`
    # hits; clamp nnz to match so downstream scatters never believe more
    # entries exist than were actually compacted
    nnz = jnp.minimum(jnp.sum(m), capacity).astype(jnp.int32)
    (idx,) = jnp.nonzero(m, size=capacity, fill_value=dense.shape[0] - 1)
    idx = idx.astype(jnp.int32)
    vals = dense[idx]
    return SparseVector(idx, vals, nnz)


def sparse_to_reference_packed(sv: SparseVector) -> np.ndarray:
    """Export to the reference's packed (index,val) format with the nnz header
    (graphlily/global.h:152-164) for parity checks. Host-side."""
    n = int(sv.nnz)
    out = np.zeros((n + 1, 2), dtype=np.float64)
    out[0, 0] = n
    out[1:, 0] = np.asarray(sv.indices[:n])
    out[1:, 1] = np.asarray(sv.values[:n])
    return out


def reference_packed_to_sparse(packed, capacity: int, dtype=jnp.float32) -> SparseVector:
    """Import from the reference's packed format (element 0 = header)."""
    packed = np.asarray(packed)
    n = int(packed[0][0]) if packed.ndim == 2 else int(packed[0])
    idx = [int(packed[i + 1][0]) for i in range(n)]
    val = [float(packed[i + 1][1]) for i in range(n)]
    return sparse_from_entries(idx, val, capacity, dtype=dtype)
