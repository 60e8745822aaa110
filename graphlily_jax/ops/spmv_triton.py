"""Semiring SpMV as a Pallas kernel on the Triton route, for NVIDIA GPUs.

XLA's product (`xla_product`) issues one atomic per edge into the output,
and consecutive edges of a row-sorted COO hit the same address, so the
atomics serialize. This kernel reduces each row run inside a block first
and issues one atomic per run. Each program takes a fixed block of nnz
(not a block of rows, so power-law rows stay balanced): coalesced loads of
rows/cols/vals and a gather of x (which stays in L2 for graphs up to ~12M
vertices in f32).

The block is then reduced as a binary tree over its lanes. A node stands
for a stretch of lanes and holds its head row with the reduction of its
head run, and its tail row with that of its tail run. Joining two
neighbours merges the left tail run with the right head run when their
rows match; a run that can grow no more (it starts and ends inside the
joined stretch) goes out by one atomic. The root's head and tail runs,
which may continue into the neighbouring blocks, go out last. Every
reduction combines entries of one row only, so a row's sum carries the
rounding of its own contributions and never that of its neighbours.

Sums (arithmetic, and logical as 0/1 counts) use atomic adds in f32.
Triton has no float atomic min, so tropical mins go out as atomic mins on
an order-preserving int32 key of the f32 value.

Rows must be sorted (CSR order). The output buffer has one spare slot at
`num_rows`, where COO padding rows and lanes that emit nothing point.
`interpret=True` runs the kernel on the CPU for tests; the interpreter has
no masked atomics, and its atomics keep one update per repeated index, so
lanes that emit nothing write the identity into the spare slot, and the
rows an atomic call emits are unique.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..semiring import Semiring, OpType

# nnz and warps per program, measured on an H100 (PERF.md)
BLOCK, WARPS = 256, 1


def _f32_key(v):
    """Order-preserving int32 view of f32."""
    return _flip(jax.lax.bitcast_convert_type(v, jnp.int32))


def _flip(k):
    """Its own inverse: maps f32 bit patterns to keys and back."""
    return k ^ ((k >> 31) & jnp.int32(0x7FFFFFFF))


def _np_f32_key(v) -> int:
    """`_f32_key` of a host constant."""
    bits = int(np.asarray(v, np.float32).view(np.int32))
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _kernel(rows_ref, cols_ref, vals_ref, x_ref, acc_in_ref, acc_ref, *,
            semiring: Semiring, num_rows: int, nnz: int, block: int,
            use_mask: bool):
    del acc_in_ref   # aliased with acc_ref
    is_min = semiring.op == OpType.ADDMIN
    trash = jnp.int32(num_rows)
    plus = jnp.minimum if is_min else jnp.add

    def emit(idx, val, cond):
        if is_min:
            fn, val, fill = plgpu.atomic_min, _f32_key(val), _np_f32_key(
                semiring.zero)
        else:
            fn, fill = plgpu.atomic_add, 0.0
        cond = cond & (idx < trash)
        fn(acc_ref, jnp.where(cond, idx, trash),
           jnp.where(cond, val, jnp.asarray(fill, val.dtype)),
           mask=cond if use_mask else None)

    at = pl.program_id(0) * block
    live = at + jnp.arange(block) < nnz
    r = plgpu.load(rows_ref.at[pl.ds(at, block)], mask=live, other=trash)
    c = plgpu.load(cols_ref.at[pl.ds(at, block)], mask=live, other=0)
    v = plgpu.load(vals_ref.at[pl.ds(at, block)], mask=live, other=0)
    contrib = semiring.mul(v, plgpu.load(x_ref.at[c]))

    # leaves: one lane each, its row both head and tail
    h, t, hs, ts = r, r, contrib, contrib
    n = block
    while n > 1:
        n //= 2
        (hl, hr), (tl, tr) = _halves(h, n), _halves(t, n)
        (hsl, hsr), (tsl, tsr) = _halves(hs, n), _halves(ts, n)
        join = tl == hr
        one_l, one_r = hl == tl, hr == tr       # a node of one run
        merged = plus(tsl, hsr)
        # left's tail run is complete unless it is also left's head run
        emit(tl, jnp.where(join, merged, tsl), ~one_l & (~join | ~one_r))
        emit(hr, hsr, ~join & ~one_r)
        h, t = hl, tr
        hs = jnp.where(one_l & join, merged, hsl)
        ts = jnp.where(one_r & join, merged, tsr)
    emit(h, hs, True)
    emit(t, ts, t != h)


def _halves(a, n: int):
    """(left, right) members of the n neighbour pairs of a."""
    a = a.reshape(n, 2)
    left = jnp.arange(2)[None, :] == 0
    zero = jnp.zeros((), a.dtype)
    return (jnp.sum(jnp.where(left, a, zero), axis=1),
            jnp.sum(jnp.where(left, zero, a), axis=1))


@functools.partial(jax.jit, static_argnames=("semiring", "interpret",
                                             "block", "warps"))
def spmv_triton(coo, x: jax.Array, semiring: Semiring,
                interpret: bool = False, block: int = BLOCK,
                warps: int = WARPS) -> jax.Array:
    """Unmasked y = A (x) x over the semiring on a row-sorted `COODevice`;
    the same result as `xla_product(coo, x, semiring, rows_sorted=True)`.
    `block`, the nnz per program, is a power of two."""
    n = coo.num_rows
    if semiring.op == OpType.ADDMIN:
        acc0 = jnp.full(n + 1, _np_f32_key(semiring.zero), jnp.int32)
    else:
        acc0 = jnp.zeros(n + 1, jnp.float32)
    kernel = functools.partial(_kernel, semiring=semiring, num_rows=n,
                               nnz=coo.rows.shape[0], block=block,
                               use_mask=not interpret)
    acc = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(acc0.shape, acc0.dtype),
        grid=(pl.cdiv(max(coo.rows.shape[0], 1), block),),
        input_output_aliases={4: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=1),
        interpret=interpret,
        name="spmv_triton",
    )(coo.rows, coo.cols, coo.vals, x, acc0)[:n]
    if semiring.op == OpType.ANDOR:
        return (acc != 0).astype(x.dtype)
    if semiring.op == OpType.ADDMIN:
        return jax.lax.bitcast_convert_type(_flip(acc), jnp.float32
                                            ).astype(x.dtype)
    return acc.astype(x.dtype)
