"""SSSP as tropical-semiring linear algebra.

Counterpart of graphlily/app/sssp.h: tropical (+,min) semiring, no mask.
Preprocessing inserts zero-weight self edges so distances are monotone under
relaxation (sssp.h:16-62). `push` chains SpMSpV with the frontier-generating
sparse assign (mode-6 kernel): candidates that improve a distance are written
and become the next frontier — the reference wires three device buffers in a
cycle (sssp.h:185-191); here the cycle is the `lax.while_loop` carry.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import TropicalSemiring, MaskType
from ..io.matrix import CSRMatrix, csr2csc, load_csr_matrix_from_float_npz
from ..io.formatter import util_round_csr_matrix_dim, add_self_edges_for_sssp
from ..module import (SpMVModule, SpMSpVModule, eWiseAddModule,
                      AssignVectorSparseModule)
from ..ops.vector import SparseVector, sparse_from_entries
from ..ops.reference import assign_vector_sparse_new_frontier, ewise_add_scalar
from .module_collection import ModuleCollection


class SSSP(ModuleCollection):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG, *legacy_args):
        super().__init__(config)
        self.semiring_ = TropicalSemiring

        self.SpMV_ = SpMVModule(config)
        self.SpMV_.set_semiring(self.semiring_)
        self.SpMV_.set_mask_type(MaskType.NO_MASK)
        self.add_module(self.SpMV_)

        self.SpMSpV_ = SpMSpVModule(config)
        self.SpMSpV_.set_semiring(self.semiring_)
        self.SpMSpV_.set_mask_type(MaskType.NO_MASK)
        self.add_module(self.SpMSpV_)

        self.SparseAssign_ = AssignVectorSparseModule(
            generate_new_frontier=True, config=config)
        self.add_module(self.SparseAssign_)

        self.eWiseAdd_ = eWiseAddModule(config)
        self.add_module(self.eWiseAdd_)

        self.matrix_num_rows_ = 0
        self.matrix_num_cols_ = 0

    def get_nnz(self) -> int:
        return self.SpMV_.get_nnz()

    def load_and_format_matrix(self, csr_matrix, skip_empty_rows: bool = False,
                               unit_weights: bool = True):
        """Reference flow (sssp.h:132-147): preprocess (self edges; unit
        weights so SSSP == BFS levels when `unit_weights`), round, CSC twin."""
        if not isinstance(csr_matrix, CSRMatrix):
            csr_matrix = load_csr_matrix_from_float_npz(csr_matrix)
        csr_matrix = csr_matrix.copy()
        if unit_weights:
            csr_matrix.adj_data = np.ones_like(csr_matrix.adj_data)
        csr_matrix = self._maybe_relabel(csr_matrix)
        csr_matrix = add_self_edges_for_sssp(csr_matrix)
        util_round_csr_matrix_dim(csr_matrix, 1024, 1024)
        csc_matrix = csr2csc(csr_matrix)
        self.SpMV_.load_and_format_matrix(csr_matrix, skip_empty_rows)
        self.SpMSpV_.load_and_format_matrix(csc_matrix)
        self.matrix_num_rows_ = self.SpMV_.get_num_rows()
        self.matrix_num_cols_ = self.SpMV_.get_num_cols()
        assert self.matrix_num_rows_ == self.matrix_num_cols_
        self._build_fused()

    def send_matrix_host_to_device(self):
        self.SpMV_.send_matrix_host_to_device()
        self.SpMSpV_.send_matrix_host_to_device()

    # ---- fused programs --------------------------------------------------
    def _build_fused(self):
        n = self.matrix_num_rows_
        spmv = self.SpMV_.apply

        @jax.jit
        def pull_fused(mstate, distance, num_iterations):
            def body(_i, d):
                # tropical SpMV relaxes distances
                return spmv(d, state=mstate)
            return jax.lax.fori_loop(0, num_iterations, body, distance)

        spmspv_dense = self.SpMSpV_.apply_dense
        inf = jnp.asarray(self.semiring_.zero, self.config.jdtype)

        def push_step(sstate, frontier, distance):
            """Dense-frontier relaxation, exactly equivalent to SpMSpV +
            frontier-generating assign (sssp.h:185-191): candidates y relax
            distances where they improve; improved entries form the next
            frontier (inactive = tropical INF). Returns (frontier, nnz, dist).
            """
            y, _ = spmspv_dense(frontier, state=sstate)
            improved = y < distance
            distance = jnp.where(improved, y, distance)
            new_frontier = jnp.where(improved, y, inf)
            nnz = jnp.sum(improved).astype(jnp.int32)
            return new_frontier, nnz, distance

        @jax.jit
        def push_fused(sstate, frontier_dense, distance, num_iterations):
            def body(_i, st):
                fr, dist = st
                fr, _nnz, dist = push_step(sstate, fr, dist)
                return (fr, dist)
            frontier, distance = jax.lax.fori_loop(
                0, num_iterations, body, (frontier_dense, distance))
            return distance

        @jax.jit
        def pull_push_fused(mstate, sstate, frontier, distance,
                            num_iterations, threshold):
            # do-while push (sssp.h:222-229): iteration j==1 always, then
            # while j < num_iterations and last frontier still sparse.
            def push_cond(carry):
                it, _fr, nnz, _d = carry
                sparse = nnz.astype(jnp.float32) / n < threshold
                return jnp.logical_or(
                    it == 0,
                    jnp.logical_and(it + 1 < num_iterations, sparse))

            def push_body(carry):
                it, fr, _nnz, dist = carry
                fr, nnz, dist = push_step(sstate, fr, dist)
                return (it + 1, fr, nnz, dist)

            it, _fr, _nnz, dist = jax.lax.while_loop(
                push_cond, push_body,
                (jnp.asarray(0, jnp.int32), frontier,
                 jnp.asarray(1, jnp.int32), distance))

            # switch: pull directly on the dense distance vector (sssp.h:233-236)
            def pull_cond(carry):
                it2, _d = carry
                return it2 < num_iterations

            def pull_body(carry):
                it2, d = carry
                return (it2 + 1, spmv(d, state=mstate))

            _, dist = jax.lax.while_loop(pull_cond, pull_body, (it, dist))
            return dist

        self._pull_fused = pull_fused
        self._push_fused = push_fused
        self._pull_push_fused = pull_push_fused

    def _init_distance(self, source: int):
        d = np.full(self.matrix_num_rows_, self.semiring_.zero,
                    self.config.dtype)
        d[source] = 0
        return jnp.asarray(d)

    # ---- public API ------------------------------------------------------
    def pull(self, source: int, num_iterations: int,
             device_output: bool = False):
        source = self._internal_source(source)
        dev = self._pull_fused(
            self.SpMV_.device_state(),
            self._init_distance(source),
            jnp.asarray(num_iterations))
        if device_output:
            return dev
        return self._external(np.asarray(dev))

    def push(self, source: int, num_iterations: int,
             device_output: bool = False):
        source = self._internal_source(source)
        # dense frontier: INF except source=0
        frontier = self._init_distance(source)
        dev = self._push_fused(
            self.SpMSpV_.device_state(), frontier,
            self._init_distance(source),
            jnp.asarray(num_iterations))
        if device_output:
            return dev
        return self._external(np.asarray(dev))

    def pull_push(self, source: int, num_iterations: int,
                  threshold: float = 0.05, device_output: bool = False):
        source = self._internal_source(source)
        # dense frontier: INF except source=0
        frontier = self._init_distance(source)
        dev = self._pull_push_fused(
            self.SpMV_.device_state(), self.SpMSpV_.device_state(),
            frontier, self._init_distance(source),
            jnp.asarray(num_iterations),
            jnp.asarray(threshold, jnp.float32))
        if device_output:
            # raw device distances, no D2H fetch and no external relabel —
            # for device-side chaining or kernel timing
            return dev
        return self._external(np.asarray(dev))

    def pull_push_time_breakdown(self, source: int, num_iterations: int,
                                 threshold: float = 0.05) -> dict:
        """Instrumented pull_push: per-phase host timings with the fused
        loop's iteration semantics (counterpart of the reference's
        instrumented apps, app/bfs.h:222-347 / app/pagerank.h:93-147). Each
        phase is a separate jitted call synced with block_until_ready;
        `dispatch_floor_ms` is the host dispatch overhead per call, measured
        on a trivial jitted call, and `dispatch_overhead_ms` that floor times
        the number of calls: subtract it to approximate device time."""
        from ..utils.profiling import PhaseTimer
        import time as _time
        source = self._internal_source(source)
        n = self.matrix_num_rows_
        sstate = self.SpMSpV_.device_state()
        mstate = self.SpMV_.device_state()
        inf = jnp.asarray(self.semiring_.zero, self.config.jdtype)
        if getattr(self, "_ops_instr", None) is None:
            spmspv_dense = self.SpMSpV_.apply_dense
            spmv = self.SpMV_.apply

            def _push(fr, dist, st):
                y, _ = spmspv_dense(fr, state=st)
                return y

            def _relax(y, dist):
                improved = y < dist
                return (jnp.where(improved, y, dist),
                        jnp.where(improved, y, inf),
                        jnp.sum(improved).astype(jnp.int32))

            self._ops_instr = dict(
                spmspv=jax.jit(_push),
                relax=jax.jit(_relax),
                spmv=jax.jit(lambda d, st: spmv(d, state=st)),
            )
        ops = self._ops_instr
        d0 = self._init_distance(source)
        y = ops["spmspv"](d0, d0, sstate)          # compile warm-up
        ops["relax"](y, d0)
        ops["spmv"](d0, mstate)
        f = jax.jit(lambda v: v[:8].sum())
        v = jnp.ones(128)
        np.asarray(f(v))
        t0 = _time.perf_counter()
        for _ in range(4):
            np.asarray(f(v))
        floor_ms = (_time.perf_counter() - t0) / 4 * 1e3

        timer = PhaseTimer()
        calls = {"spmspv": 0, "relax": 0, "nnz_readback": 0, "spmv": 0}
        frontier = self._init_distance(source)
        distance = self._init_distance(source)
        it = 0
        push_iters = 0
        t_all = _time.perf_counter()
        while True:  # do-while push (sssp.h:222-229)
            with timer.phase("push_spmspv"):
                y = ops["spmspv"](frontier, distance, sstate)
                y.block_until_ready()
            calls["spmspv"] += 1
            with timer.phase("push_relax"):
                distance, frontier, nnz = ops["relax"](y, distance)
                distance.block_until_ready()
            calls["relax"] += 1
            it += 1
            push_iters += 1
            with timer.phase("nnz_readback"):
                nnz_host = int(nnz)
            calls["nnz_readback"] += 1
            if not (it < num_iterations and nnz_host / n < threshold):
                break
        pull_iters = 0
        while it < num_iterations:
            it += 1
            pull_iters += 1
            with timer.phase("pull_spmv"):
                distance = ops["spmv"](distance, mstate)
                distance.block_until_ready()
            calls["spmv"] += 1
        total_ms = (_time.perf_counter() - t_all) * 1e3
        ncalls = sum(calls.values())
        return {
            "phases_ms": dict(timer.times_ms),
            "push_iterations": push_iters,
            "pull_iterations": pull_iters,
            "calls": calls,
            "dispatch_floor_ms": floor_ms,
            "dispatch_overhead_ms": floor_ms * ncalls,
            "total_ms": total_ms,
            "total_minus_dispatch_ms": max(total_ms - floor_ms * ncalls, 0.0),
            "distance": self._external(np.asarray(distance)),
        }

    # ---- CPU oracle (sssp.h:248-256) -------------------------------------
    def compute_reference_results(self, source: int, num_iterations: int):
        source = self._internal_source(source)
        d = np.full(self.matrix_num_rows_, self.semiring_.zero, np.float64)
        d[source] = 0
        for _ in range(num_iterations):
            d = self.SpMV_.compute_reference_results(d)
        return self._external(d)
