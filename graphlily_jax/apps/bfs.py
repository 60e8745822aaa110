"""BFS as graph linear algebra.

Counterpart of graphlily/app/bfs.h: logical semiring; SpMV masked
WRITE_TO_ZERO against the distance vector (visited vertices drop out),
DenseAssign WRITE_TO_ONE stamps `iter+1` into distances at the new frontier.
`pull` iterates masked SpMV; `push` iterates SpMSpV + sparse assign;
`pull_push` pushes until the frontier densifies past `threshold`, then pulls
(app/bfs.h:160-219).

Execution styles:
  * fused (default): the whole iteration loop is ONE jitted program
    (`lax.while_loop` with the frontier nnz in the carry) — the device-side
    counterpart of the reference's zero-host-involvement buffer binding;
    the reference's only per-iteration host sync (get_results_nnz,
    bfs.h:182) becomes an on-device scalar.
  * chained: literal module-by-module execution through DeviceBuffers,
    mirroring the reference call sequence op for op (used for cross-checks).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import LogicalSemiring, MaskType
from ..io.matrix import CSRMatrix, csr2csc, load_csr_matrix_from_float_npz
from ..io.formatter import util_round_csr_matrix_dim
from ..module import (SpMVModule, SpMSpVModule, eWiseAddModule,
                      AssignVectorDenseModule, AssignVectorSparseModule)
from ..ops.vector import SparseVector, sparse_from_entries, sparse_to_dense
from ..ops.reference import (assign_vector_dense,
                             assign_vector_sparse_no_new_frontier)
from .module_collection import ModuleCollection


class BFS(ModuleCollection):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG, *legacy_args):
        super().__init__(config)
        self.semiring_ = LogicalSemiring

        self.SpMV_ = SpMVModule(config)
        self.SpMV_.set_semiring(self.semiring_)
        self.SpMV_.set_mask_type(MaskType.WRITE_TO_ZERO)
        self.add_module(self.SpMV_)

        self.DenseAssign_ = AssignVectorDenseModule(config)
        self.DenseAssign_.set_mask_type(MaskType.WRITE_TO_ONE)
        self.add_module(self.DenseAssign_)

        self.SpMSpV_ = SpMSpVModule(config)
        self.SpMSpV_.set_semiring(self.semiring_)
        self.SpMSpV_.set_mask_type(MaskType.WRITE_TO_ZERO)
        self.add_module(self.SpMSpV_)

        self.SparseAssign_ = AssignVectorSparseModule(
            generate_new_frontier=False, config=config)
        self.add_module(self.SparseAssign_)

        self.eWiseAdd_ = eWiseAddModule(config)
        self.add_module(self.eWiseAdd_)

        self.matrix_num_rows_ = 0
        self.matrix_num_cols_ = 0

    def get_nnz(self) -> int:
        return self.SpMV_.get_nnz()

    # ---- setup -----------------------------------------------------------
    def load_and_format_matrix(self, csr_matrix, skip_empty_rows: bool = False):
        """Accepts a CSRMatrix or an npz path. Reference flow
        (app/bfs.h:85-99): round dims, set all weights to 1, build CSC twin."""
        if not isinstance(csr_matrix, CSRMatrix):
            csr_matrix = load_csr_matrix_from_float_npz(csr_matrix)
        csr_matrix = csr_matrix.copy()
        csr_matrix = self._maybe_relabel(csr_matrix)
        util_round_csr_matrix_dim(csr_matrix, 1024, 1024)
        csr_matrix.adj_data = np.ones_like(csr_matrix.adj_data)
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

    # ---- fused on-device programs ---------------------------------------
    def _build_fused(self):
        n = self.matrix_num_rows_
        spmv = self.SpMV_.apply

        def pull_step(mstate, iter_num, frontier, distance):
            """One pull iteration `iter_num` (1-based): masked SpMV then stamp
            distance = iter_num+1 at the new frontier (bfs.h:117-124)."""
            y = spmv(frontier, distance, state=mstate)
            val = (iter_num + 1).astype(distance.dtype)
            distance = assign_vector_dense(distance, y, val,
                                           MaskType.WRITE_TO_ONE)
            return y, distance

        spmspv_dense = self.SpMSpV_.apply_dense

        def push_step(sstate, iter_num, frontier, distance):
            """One push iteration: SpMSpV then stamp iter_num+1 at the
            frontier (bfs.h:148-153). The frontier stays DENSE through the
            fused loop (exactly equivalent: the sparse results are the
            nonzeros of the masked product, and the sparse assign writes val
            at exactly those indices) — avoids per-iteration scatter/nonzero.
            Returns (frontier, nnz, distance)."""
            y, nnz = spmspv_dense(frontier, distance, state=sstate)
            val = (iter_num + 1).astype(distance.dtype)
            distance = jnp.where(y != 0, val, distance)
            return y, nnz, distance

        @jax.jit
        def pull_fused(mstate, frontier, distance, num_iterations):
            def body(i, st):
                fr, dist = st
                return pull_step(mstate, i, fr, dist)
            frontier, distance = jax.lax.fori_loop(
                1, num_iterations + 1, body, (frontier, distance))
            return distance

        @jax.jit
        def push_fused(sstate, frontier_dense, distance, num_iterations):
            def body(i, st):
                fr, dist = st
                fr, _nnz, dist = push_step(sstate, i, fr, dist)
                return (fr, dist)
            frontier, distance = jax.lax.fori_loop(
                1, num_iterations + 1, body, (frontier_dense, distance))
            return distance

        @jax.jit
        def pull_push_fused(mstate, sstate, frontier, distance,
                            num_iterations, threshold):
            # Phase 1: push (do-while: iteration j runs for j==1 always, then
            # while j < num_iterations and the frontier is still sparse —
            # bfs.h:179-190). Carry `it` = completed push iterations.
            def push_cond(carry):
                it, _fr, nnz, _dist = carry
                sparse = nnz.astype(jnp.float32) / n < threshold
                first = it == 0
                more = jnp.logical_and(it + 1 < num_iterations, sparse)
                return jnp.logical_or(first, more)

            def push_body(carry):
                it, fr, _nnz, dist = carry
                fr, nnz, dist = push_step(sstate, it + 1, fr, dist)
                return (it + 1, fr, nnz, dist)

            it, fr, _nnz, dist = jax.lax.while_loop(
                push_cond, push_body,
                (jnp.asarray(0, jnp.int32), frontier,
                 jnp.asarray(1, jnp.int32), distance))

            # Switch (bfs.h:195-205): the frontier is already dense
            dense_frontier = fr

            # Phase 2: pull for the remaining iterations it+1 .. num_iterations
            def pull_cond(carry):
                it2, _fr, _dist = carry
                return it2 < num_iterations

            def pull_body(carry):
                it2, fr2, dist2 = carry
                fr2, dist2 = pull_step(mstate, it2 + 1, fr2, dist2)
                return (it2 + 1, fr2, dist2)

            _, _, dist = jax.lax.while_loop(
                pull_cond, pull_body, (it, dense_frontier, dist))
            return dist

        self._pull_fused = pull_fused
        self._push_fused = push_fused
        self._pull_push_fused = pull_push_fused

    def _init_state(self, source: int):
        n = self.matrix_num_rows_
        dtype = self.config.jdtype
        input_ = np.full(n, self.semiring_.zero, dtype)
        distance = np.zeros(n, dtype)
        input_[source] = 1
        distance[source] = 1
        return jnp.asarray(input_), jnp.asarray(distance)

    # ---- public API (reference signatures, app/bfs.h) --------------------
    def pull(self, source: int, num_iterations: int, chained: bool = False,
             device_output: bool = False):
        source = self._internal_source(source)
        if chained:
            return self._external(self._pull_chained(source, num_iterations))
        frontier, distance = self._init_state(source)
        dev = self._pull_fused(self.SpMV_.device_state(), frontier, distance,
                               jnp.asarray(num_iterations))
        if device_output:
            return dev
        return self._external(np.asarray(dev))

    def push(self, source: int, num_iterations: int, chained: bool = False,
             device_output: bool = False):
        source = self._internal_source(source)
        if chained:
            return self._external(self._push_chained(source, num_iterations))
        frontier, distance = self._init_state(source)
        dev = self._push_fused(self.SpMSpV_.device_state(), frontier,
                               distance, jnp.asarray(num_iterations))
        if device_output:
            return dev
        return self._external(np.asarray(dev))

    def pull_push(self, source: int, num_iterations: int,
                  threshold: float = 0.05, device_output: bool = False):
        source = self._internal_source(source)
        frontier, distance = self._init_state(source)
        dev = self._pull_push_fused(
            self.SpMV_.device_state(), self.SpMSpV_.device_state(),
            frontier, distance, jnp.asarray(num_iterations),
            jnp.asarray(threshold, jnp.float32))
        if device_output:
            # raw device distances, no D2H fetch and no external relabel —
            # for device-side chaining or kernel timing
            return dev
        return self._external(np.asarray(dev))

    def pull_push_time_breakdown(self, source: int, num_iterations: int,
                                 threshold: float = 0.05) -> dict:
        """Instrumented pull_push: per-phase host timings with the same
        iteration semantics as the fused loop. Counterpart of
        BFS::pull_push_time_breakdown (app/bfs.h:222-347), which splits
        compute/assign/transfer per phase. Here each phase is its own jitted
        call synced with block_until_ready; `dispatch_floor_ms` is the host
        dispatch overhead per call, measured on a trivial jitted call
        (subtract n_calls x floor to approximate device time — the fused
        loop is the production path)."""
        from ..utils.profiling import PhaseTimer
        import time as _time
        source = self._internal_source(source)
        n = self.matrix_num_rows_
        sstate = self.SpMSpV_.device_state()
        mstate = self.SpMV_.device_state()
        if getattr(self, "_ops_instr", None) is None:
            spmspv_dense = self.SpMSpV_.apply_dense
            spmv = self.SpMV_.apply
            self._ops_instr = dict(
                spmspv=jax.jit(lambda fr, dist, st:
                               spmspv_dense(fr, dist, state=st)),
                push_assign=jax.jit(lambda y, dist, val:
                                    jnp.where(y != 0, val, dist)),
                spmv=jax.jit(lambda fr, dist, st: spmv(fr, dist, state=st)),
                pull_assign=jax.jit(lambda dist, y, val: assign_vector_dense(
                    dist, y, val, MaskType.WRITE_TO_ONE)),
            )
        ops = self._ops_instr
        # warm-up (compile outside the timings)
        fr0, dist0 = self._init_state(source)
        y, nnz = ops["spmspv"](fr0, dist0, sstate)
        ops["push_assign"](y, dist0, jnp.asarray(2.0, dist0.dtype))
        y2 = ops["spmv"](fr0, dist0, mstate)
        ops["pull_assign"](dist0, y2, jnp.asarray(2.0, dist0.dtype))
        f = jax.jit(lambda v: v[:8].sum())
        v = jnp.ones(128)
        np.asarray(f(v))
        t0 = _time.perf_counter()
        for _ in range(4):
            np.asarray(f(v))
        floor_ms = (_time.perf_counter() - t0) / 4 * 1e3

        timer = PhaseTimer()
        calls = {"spmspv": 0, "push_assign": 0, "nnz_readback": 0,
                 "spmv": 0, "pull_assign": 0}
        frontier, distance = self._init_state(source)
        it = 0
        push_iters = 0
        t_all = _time.perf_counter()
        while True:  # do-while push (bfs.h:179-190)
            with timer.phase("push_spmspv"):
                frontier, nnz = ops["spmspv"](frontier, distance, sstate)
                frontier.block_until_ready()
            calls["spmspv"] += 1
            it += 1
            push_iters += 1
            with timer.phase("push_assign"):
                distance = ops["push_assign"](
                    frontier, distance, jnp.asarray(it + 1, distance.dtype))
                distance.block_until_ready()
            calls["push_assign"] += 1
            with timer.phase("nnz_readback"):
                nnz_host = int(nnz)   # the reference's get_results_nnz D2D
            calls["nnz_readback"] += 1
            if not (it < num_iterations and nnz_host / n < threshold):
                break
        pull_iters = 0
        while it < num_iterations:
            it += 1
            pull_iters += 1
            with timer.phase("pull_spmv"):
                frontier = ops["spmv"](frontier, distance, mstate)
                frontier.block_until_ready()
            calls["spmv"] += 1
            with timer.phase("pull_assign"):
                distance = ops["pull_assign"](
                    distance, frontier, jnp.asarray(it + 1, distance.dtype))
                distance.block_until_ready()
            calls["pull_assign"] += 1
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

    # ---- chained (module-by-module) variants for cross-checking ----------
    def _pull_chained(self, source, num_iterations):
        frontier, distance = self._init_state(source)
        self.SpMV_.send_vector_host_to_device(np.asarray(frontier))
        self.SpMV_.send_mask_host_to_device(np.asarray(distance))
        self.DenseAssign_.bind_mask_buf(self.SpMV_.vector_buf)
        self.DenseAssign_.bind_inout_buf(self.SpMV_.mask_buf)
        self.eWiseAdd_.bind_in_buf(self.SpMV_.results_buf)
        self.eWiseAdd_.bind_out_buf(self.SpMV_.vector_buf)
        for it in range(1, num_iterations + 1):
            self.SpMV_.run()
            self.eWiseAdd_.run(self.matrix_num_rows_, 0)
            self.DenseAssign_.run(self.matrix_num_rows_, it + 1)
        return self.SpMV_.send_mask_device_to_host()

    def _push_chained(self, source, num_iterations):
        _, distance = self._init_state(source)
        self.SpMSpV_.send_vector_host_to_device(([source], [1.0]))
        self.SpMSpV_.send_mask_host_to_device(np.asarray(distance))
        self.SparseAssign_.bind_mask_buf(self.SpMSpV_.vector_buf)
        self.SparseAssign_.bind_inout_buf(self.SpMSpV_.mask_buf)
        for it in range(1, num_iterations + 1):
            self.SpMSpV_.run()
            self.SpMSpV_.copy_buffer_device_to_device(
                self.SpMSpV_.results_buf, self.SpMSpV_.vector_buf)
            self.SparseAssign_.run(it + 1)
        return self.SpMSpV_.send_mask_device_to_host()

    # ---- CPU oracle (reference: app/bfs.h:350-360) -----------------------
    def compute_reference_results(self, source: int, num_iterations: int):
        source = self._internal_source(source)
        n = self.matrix_num_rows_
        input_ = np.full(n, self.semiring_.zero, np.float64)
        distance = np.zeros(n, np.float64)
        input_[source] = 1
        distance[source] = 1
        for it in range(1, num_iterations + 1):
            input_ = self.SpMV_.compute_reference_results(input_, distance)
            self.DenseAssign_.compute_reference_results(
                input_, distance, n, it + 1)
        return self._external(distance)
