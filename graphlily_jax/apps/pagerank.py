"""PageRank.

Counterpart of graphlily/app/pagerank.h: arithmetic semiring, no mask.
The matrix is outdegree-normalized and pre-scaled by the damping factor at
format time (pagerank.h:60-72); one iteration is rank = A_scaled @ rank +
(1-d)/N (SpMV + eWiseAdd, pagerank.h:80-90).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import ArithmeticSemiring, MaskType
from ..io.matrix import CSRMatrix, load_csr_matrix_from_float_npz
from ..io.formatter import (util_round_csr_matrix_dim,
                            util_normalize_csr_matrix_by_outdegree)
from ..module import SpMVModule, eWiseAddModule
from ..ops.reference import ewise_add_scalar
from .module_collection import ModuleCollection


class PageRank(ModuleCollection):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG, *legacy_args):
        super().__init__(config)
        self.semiring_ = ArithmeticSemiring
        self.SpMV_ = SpMVModule(config)
        self.SpMV_.set_semiring(self.semiring_)
        self.SpMV_.set_mask_type(MaskType.NO_MASK)
        self.add_module(self.SpMV_)
        self.eWiseAdd_ = eWiseAddModule(config)
        self.add_module(self.eWiseAdd_)
        self.matrix_num_rows_ = 0
        self.matrix_num_cols_ = 0

    def get_nnz(self) -> int:
        return self.SpMV_.get_nnz()

    def load_and_format_matrix(self, csr_matrix, damping: float = 0.9,
                               skip_empty_rows: bool = False):
        if not isinstance(csr_matrix, CSRMatrix):
            csr_matrix = load_csr_matrix_from_float_npz(csr_matrix)
        csr_matrix = csr_matrix.copy()
        csr_matrix = self._maybe_relabel(csr_matrix)
        util_round_csr_matrix_dim(csr_matrix, 1024, 1024)
        util_normalize_csr_matrix_by_outdegree(csr_matrix)
        csr_matrix.adj_data = (csr_matrix.adj_data * damping).astype(
            csr_matrix.adj_data.dtype)
        self.SpMV_.load_and_format_matrix(csr_matrix, skip_empty_rows)
        self.matrix_num_rows_ = self.SpMV_.get_num_rows()
        self.matrix_num_cols_ = self.SpMV_.get_num_cols()
        assert self.matrix_num_rows_ == self.matrix_num_cols_
        self._build_fused()

    def send_matrix_host_to_device(self):
        self.SpMV_.send_matrix_host_to_device()

    def _build_fused(self):
        spmv = self.SpMV_.apply

        @jax.jit
        def pull_fused(mstate, rank, offset, num_iterations):
            def body(_i, r):
                return ewise_add_scalar(spmv(r, state=mstate), offset)
            return jax.lax.fori_loop(0, num_iterations, body, rank)

        self._pull_fused = pull_fused

    def pull(self, damping: float, num_iterations: int,
             device_output: bool = False):
        n = self.matrix_num_rows_
        rank = jnp.full(n, 1.0 / n, self.config.jdtype)
        offset = jnp.asarray((1 - damping) / n, self.config.jdtype)
        dev = self._pull_fused(self.SpMV_.device_state(), rank, offset,
                               jnp.asarray(num_iterations))
        if device_output:
            # raw device array, no D2H and no external relabel — the
            # device-resident result for chaining or timing
            return dev
        return self._external(np.asarray(dev))

    def pull_time_breakdown(self, damping: float,
                            num_iterations: int) -> dict:
        """Instrumented pull: per-phase host timings with the fused loop's
        iteration semantics — counterpart of the reference's instrumented
        PageRank (app/pagerank.h:93-147, which splits SpMV from eWiseAdd
        per iteration). Each phase is a separate jitted call synced per
        iteration; `dispatch_floor_ms` is the host dispatch overhead per
        call, measured on a trivial jitted call, and `dispatch_overhead_ms`
        that floor times the number of calls: subtract it to approximate
        device time. The summed `distance`-style result matches pull() exactly
        (same ops, same order)."""
        from ..utils.profiling import PhaseTimer
        import time as _time
        n = self.matrix_num_rows_
        mstate = self.SpMV_.device_state()
        if getattr(self, "_ops_instr", None) is None:
            spmv = self.SpMV_.apply
            self._ops_instr = dict(
                spmv=jax.jit(lambda r, st: spmv(r, state=st)),
                ewise=jax.jit(ewise_add_scalar),
            )
        ops = self._ops_instr
        rank = jnp.full(n, 1.0 / n, self.config.jdtype)
        offset = jnp.asarray((1 - damping) / n, self.config.jdtype)
        ops["ewise"](ops["spmv"](rank, mstate), offset)  # compile warm-up
        f = jax.jit(lambda v: v[:8].sum())
        v = jnp.ones(128)
        np.asarray(f(v))
        t0 = _time.perf_counter()
        for _ in range(4):
            np.asarray(f(v))
        floor_ms = (_time.perf_counter() - t0) / 4 * 1e3

        timer = PhaseTimer()
        calls = {"spmv": 0, "ewise_add": 0}
        t_all = _time.perf_counter()
        for _ in range(num_iterations):
            with timer.phase("spmv"):
                y = ops["spmv"](rank, mstate)
                y.block_until_ready()
            calls["spmv"] += 1
            with timer.phase("ewise_add"):
                rank = ops["ewise"](y, offset)
                rank.block_until_ready()
            calls["ewise_add"] += 1
        total_ms = (_time.perf_counter() - t_all) * 1e3
        ncalls = sum(calls.values())
        return {
            "phases_ms": dict(timer.times_ms),
            "iterations": num_iterations,
            "calls": calls,
            "dispatch_floor_ms": floor_ms,
            "dispatch_overhead_ms": floor_ms * ncalls,
            "total_ms": total_ms,
            "total_minus_dispatch_ms": max(total_ms - floor_ms * ncalls, 0.0),
            "rank": self._external(np.asarray(rank)),
        }

    def compute_reference_results(self, damping: float, num_iterations: int):
        """pagerank.h:150-159."""
        n = self.matrix_num_rows_
        rank = np.full(n, 1.0 / n, np.float64)
        for _ in range(num_iterations):
            rank = self.SpMV_.compute_reference_results(rank)
            rank = rank + (1 - damping) / n
        return self._external(rank)
