"""Multi-device distributed SpMV over a 2D device mesh.

An extension beyond the reference, which is strictly single-FPGA
(SURVEY.md section 5.8 — its "fabric" is 16 on-package HBM channels). The
natural scale-out of that design maps the channel axis onto a device mesh:

  mesh = (rows, cols)
  * matrix block-sharded: device (i,j) holds the COO of row-block i x
    col-block j (a 2D SUMMA decomposition), padded to the largest block's
    nnz;
  * x sharded over 'cols' (each device gathers only from its local x slice —
    the multi-device analog of the reference's per-channel vector URAM slice);
  * partial y combined over 'cols' (psum, pmax or pmin — XLA hands the
    collective to NCCL on GPUs), y emerges sharded over 'rows';
  * iterating apps reshard y('rows') -> x('cols') with a sharding constraint,
    letting XLA place the all-to-all.

Per-shard compute is the single-device product (ops/reference.py
`coo_product`) on the block's local COO.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import Semiring, MaskType, OpType, apply_mask
from ..io.matrix import CSRMatrix
from ..io.formatter import util_round_csr_matrix_dim
from ..ops.reference import COODevice, coo_product


@dataclasses.dataclass
class ShardedSpMVLayout:
    """Per-block COO arrays with leading (rows_shards, col_shards) mesh dims.
    Every block is padded to `block_nnz.max()` entries whose local row is
    `local_rows`, which the segment reduce drops."""

    rows: np.ndarray    # (R, C, max_block_nnz) int32, block-local row ids
    cols: np.ndarray    # (R, C, max_block_nnz) int32, block-local col ids
    vals: np.ndarray    # (R, C, max_block_nnz)
    num_rows: int       # global padded
    num_cols: int
    nnz: int
    rows_shards: int
    col_shards: int
    local_rows: int
    local_cols: int
    block_nnz: np.ndarray   # (R, C) real nnz per block, before padding

    @property
    def shard_balance(self) -> float:
        """max/avg block nnz: the wall-clock stretch that padding every
        block to the largest one costs on skewed graphs."""
        avg = float(self.block_nnz.mean())
        return float(self.block_nnz.max()) / max(avg, 1e-9)


def pack_sharded(csr: CSRMatrix, rows_shards: int, col_shards: int,
                 config: EngineConfig = DEFAULT_CONFIG) -> ShardedSpMVLayout:
    """Split CSR into (R x C) COO blocks; dims are rounded up to multiples
    of shards*1024. A stable sort by block id keeps each block's entries in
    CSR (row-ascending) order."""
    work = util_round_csr_matrix_dim(csr.copy(), rows_shards * 1024,
                                     col_shards * 1024)
    nrows, ncols = work.num_rows, work.num_cols
    rb, cb = nrows // rows_shards, ncols // col_shards
    nnz = work.nnz
    rows = work.row_ids()
    cols = work.adj_indices[:nnz].astype(np.int64)
    block = (rows // rb) * col_shards + cols // cb
    order = np.argsort(block, kind="stable")
    counts = np.bincount(block, minlength=rows_shards * col_shards)
    width = max(int(counts.max()), 1)
    # slot of each sorted entry inside its block
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    sblock = block[order]
    slot = np.arange(nnz) - starts[sblock]

    nblk = rows_shards * col_shards
    out_rows = np.full((nblk, width), rb, np.int32)
    out_cols = np.zeros((nblk, width), np.int32)
    out_vals = np.zeros((nblk, width), np.dtype(config.dtype))
    out_rows[sblock, slot] = rows[order] % rb
    out_cols[sblock, slot] = cols[order] % cb
    out_vals[sblock, slot] = work.adj_data[:nnz][order]
    shape = (rows_shards, col_shards, width)
    return ShardedSpMVLayout(
        rows=out_rows.reshape(shape), cols=out_cols.reshape(shape),
        vals=out_vals.reshape(shape),
        num_rows=nrows, num_cols=ncols, nnz=nnz,
        rows_shards=rows_shards, col_shards=col_shards,
        local_rows=rb, local_cols=cb,
        block_nnz=counts.reshape(rows_shards, col_shards).astype(np.int64))


@jax.tree_util.register_pytree_node_class
class DistSpMV:
    """y = mask(A (x) x) over a 2D mesh. A pytree whose leaves are the
    sharded block arrays, so jitted app loops take the engine as an
    argument rather than embedding the matrix as constants."""

    def __init__(self, layout: ShardedSpMVLayout, semiring: Semiring,
                 mesh: Mesh, config: EngineConfig = DEFAULT_CONFIG,
                 mask_type: MaskType = MaskType.NO_MASK):
        put = lambda a: jax.device_put(
            a, NamedSharding(mesh, P("rows", "cols")))
        self.rows = put(layout.rows)
        self.cols = put(layout.cols)
        self.vals = put(layout.vals.astype(config.dtype))
        self.semiring = semiring
        self.mesh = mesh
        self.mask_type = mask_type
        self.num_rows = layout.num_rows
        self.num_cols = layout.num_cols
        self.local_rows = layout.local_rows
        self.local_cols = layout.local_cols

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), (
            self.semiring, self.mesh, self.mask_type, self.num_rows,
            self.num_cols, self.local_rows, self.local_cols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        eng = object.__new__(cls)
        eng.rows, eng.cols, eng.vals = children
        (eng.semiring, eng.mesh, eng.mask_type, eng.num_rows, eng.num_cols,
         eng.local_rows, eng.local_cols) = aux
        return eng

    def _product(self, x: jax.Array) -> jax.Array:
        semiring = self.semiring
        local_rows, local_cols = self.local_rows, self.local_cols
        # cross-shard <+> combine: each shard's logical result is already
        # 0/1, so OR is a max
        combine = {OpType.MULADD: jax.lax.psum, OpType.ANDOR: jax.lax.pmax,
                   OpType.ADDMIN: jax.lax.pmin}[semiring.op]

        def local_fn(rows, cols, vals, x_local):
            coo = COODevice(rows[0, 0], cols[0, 0], vals[0, 0],
                            local_rows, local_cols, rows.shape[2])
            y_local = coo_product(coo, x_local, semiring, rows_sorted=True)
            return combine(y_local, "cols")

        spec_blocks = P("rows", "cols")
        return jax.shard_map(
            local_fn, mesh=self.mesh,
            in_specs=(spec_blocks, spec_blocks, spec_blocks, P("cols")),
            out_specs=P("rows"), check_vma=False,
        )(self.rows, self.cols, self.vals, x)

    def __call__(self, x: jax.Array, mask: jax.Array | None = None) -> jax.Array:
        y = self._product(x)
        if mask is not None and self.mask_type != MaskType.NO_MASK:
            y = apply_mask(y, mask, self.mask_type, self.semiring.zero)
        return y

    def reshard_for_input(self, y: jax.Array) -> jax.Array:
        """Reshard a row-sharded result to the col-sharded input layout
        (XLA inserts the all-to-all)."""
        return jax.lax.with_sharding_constraint(
            y, NamedSharding(self.mesh, P("cols")))
