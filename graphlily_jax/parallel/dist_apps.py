"""Fused distributed app loops over a 2D device mesh.

Multi-device extension beyond the single-FPGA reference: the WHOLE iteration
loop — masked semiring SpMV (per-shard COO product + psum/pmax/pmin over the
'cols' axis), distance stamping, and the rows->cols reshard (all-to-all
placed by XLA) — runs as ONE jitted `lax.fori_loop` program, mirroring the
single-device fused apps (apps/bfs.py, apps/sssp.py) shard-for-shard.
The loops are jitted once per engine structure: the engines are pytrees
passed as arguments (parallel/dist_spmv.py DistSpMV).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .dist_spmv import DistSpMV


def _bfs_step(eng, i, fr, dist):
    """Masked product, stamp level i+1 at the new frontier, reshard."""
    y = eng(fr, dist)
    dist = jnp.where(y != 0, (i + 1).astype(dist.dtype), dist)
    return eng.reshard_for_input(y), dist


@jax.jit
def _bfs_pull_loop(eng, frontier, distance, iters):
    def body(i, st):
        return _bfs_step(eng, i, *st)
    return jax.lax.fori_loop(1, iters + 1, body, (frontier, distance))[1]


def _bfs_init(eng, source):
    f0 = np.zeros(eng.num_cols, np.float32)
    f0[source] = 1
    d0 = np.zeros(eng.num_rows, np.float32)
    d0[source] = 1
    return jnp.asarray(f0), jnp.asarray(d0)


def _assert_square(eng):
    assert eng.num_rows == eng.num_cols, (
        "iterating apps need square padding: round the matrix to "
        "lcm(rows_shards, col_shards)*1024 on both dims before pack_sharded")


def dist_bfs_pull(eng: DistSpMV, source: int, num_iterations: int):
    """Distributed BFS pull: eng must be a LogicalSemiring DistSpMV with
    WRITE_TO_ZERO masking (the visited-vertex drop, app/bfs.h:117-124).
    Returns the distance vector (levels, 1-based at the source)."""
    _assert_square(eng)
    return np.asarray(_bfs_pull_loop(eng, *_bfs_init(eng, source),
                                     jnp.asarray(num_iterations)))


@jax.jit
def _bfs_pull_push_loop(eng_pull, eng_push, frontier, distance, iters, thr):
    n = eng_pull.num_rows

    # phase 1: push (do-while, bfs.h:179-190)
    def push_cond(carry):
        it, _fr, nnz, _dist = carry
        sparse = nnz.astype(jnp.float32) / n < thr
        return jnp.logical_or(it == 0,
                              jnp.logical_and(it + 1 < iters, sparse))

    def push_body(carry):
        it, fr, _nnz, dist = carry
        fr, dist = _bfs_step(eng_push, it + 1, fr, dist)
        return (it + 1, fr, (fr != 0).sum().astype(jnp.int32), dist)

    it, fr, _nnz, dist = jax.lax.while_loop(
        push_cond, push_body,
        (jnp.asarray(0, jnp.int32), frontier,
         jnp.asarray(1, jnp.int32), distance))

    # phase 2: pull for the remaining iterations (frontier already dense)
    def pull_body(carry):
        it2, fr2, dist2 = carry
        fr2, dist2 = _bfs_step(eng_pull, it2 + 1, fr2, dist2)
        return (it2 + 1, fr2, dist2)

    return jax.lax.while_loop(lambda c: c[0] < iters, pull_body,
                              (it, fr, dist))[2]


def dist_bfs_pull_push(eng_pull: DistSpMV, source: int,
                       num_iterations: int, threshold: float = 0.05,
                       eng_push: DistSpMV | None = None):
    """Distributed adaptive-direction BFS with the reference's exact
    iteration semantics (app/bfs.h:160-219 — do-while push while the
    frontier is sparse, then pull). Push computes the SAME A (x) frontier
    product (the reference's SpMSpV consumes A in CSC storage, not A^T);
    `eng_push` optionally supplies another engine for that product and
    defaults to `eng_pull` (dense-frontier equivalence, apps/bfs.py
    push_step). The density check is an on-device global sum XLA reduces
    across shards; the rows->cols reshard between iterations is an
    all-to-all."""
    _assert_square(eng_pull)
    return np.asarray(_bfs_pull_push_loop(
        eng_pull, eng_pull if eng_push is None else eng_push,
        *_bfs_init(eng_pull, source), jnp.asarray(num_iterations),
        jnp.asarray(threshold, jnp.float32)))


def _sssp_init(eng, source):
    d0 = np.full(eng.num_cols, float(eng.semiring.zero), np.float32)
    d0[source] = 0.0
    return jnp.asarray(d0)


@jax.jit
def _sssp_pull_push_loop(eng_pull, eng_push, frontier, distance, iters, thr):
    n = eng_pull.num_rows
    inf = jnp.asarray(eng_pull.semiring.zero, jnp.float32)

    def push_cond(carry):
        it, _fr, nnz, _d = carry
        sparse = nnz.astype(jnp.float32) / n < thr
        return jnp.logical_or(it == 0,
                              jnp.logical_and(it + 1 < iters, sparse))

    def push_body(carry):
        it, fr, _nnz, dist = carry
        y = eng_push(fr)
        improved = y < dist
        dist = jnp.where(improved, y, dist)
        fr = eng_push.reshard_for_input(jnp.where(improved, y, inf))
        nnz = jnp.sum(improved).astype(jnp.int32)
        return (it + 1, fr, nnz, dist)

    it, _fr, _nnz, dist = jax.lax.while_loop(
        push_cond, push_body,
        (jnp.asarray(0, jnp.int32), frontier,
         jnp.asarray(1, jnp.int32), distance))

    def pull_body(carry):
        it2, d = carry
        return (it2 + 1, eng_pull(eng_pull.reshard_for_input(d)))

    return jax.lax.while_loop(lambda c: c[0] < iters, pull_body,
                              (it, dist))[1]


def dist_sssp_pull_push(eng_pull, source: int, num_iterations: int,
                        threshold: float = 0.05, eng_push=None):
    """Distributed adaptive-direction SSSP (the tropical twin of
    dist_bfs_pull_push; single-chip counterpart apps/sssp.py
    pull_push_fused / reference app/sssp.h:222-236): do-while push while
    the improved-vertex frontier is sparse, then pull. The push step
    relaxes distances where candidates improve them; improved entries form
    the next frontier (inactive = tropical INF). `eng_pull` is a
    TropicalSemiring DistSpMV."""
    _assert_square(eng_pull)
    d0 = _sssp_init(eng_pull, source)
    return np.asarray(_sssp_pull_push_loop(
        eng_pull, eng_pull if eng_push is None else eng_push, d0, d0,
        jnp.asarray(num_iterations), jnp.asarray(threshold, jnp.float32)))


@jax.jit
def _sssp_pull_loop(eng, distance, iters):
    return jax.lax.fori_loop(
        0, iters, lambda _i, d: eng.reshard_for_input(eng(d)), distance)


def dist_sssp_pull(eng: DistSpMV, source: int, num_iterations: int):
    """Distributed SSSP pull: eng must be a TropicalSemiring DistSpMV
    (cross-shard combine = pmin over 'cols'). The matrix must carry the
    zero-weight self edges (add_self_edges_for_sssp) so relaxation is
    monotone, exactly as the single-chip app (apps/sssp.py)."""
    _assert_square(eng)
    return np.asarray(_sssp_pull_loop(eng, _sssp_init(eng, source),
                                      jnp.asarray(num_iterations)))
