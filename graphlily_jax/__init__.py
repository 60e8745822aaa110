"""graphlily_jax: a GraphBLAS framework in JAX.

A from-scratch rebuild of the capabilities of cornell-zhang/GraphLily
(ICCAD'21, FPGA overlay for graph linear algebra): semiring-parameterized
masked SpMV/SpMSpV as a gather plus an atomic segment reduce over COO
arrays, the apply/assign/eWiseAdd operator set, a functional module layer,
and BFS / SSSP / PageRank apps whose iteration loops run entirely on device
inside `lax.while_loop`.

Layer map (counterpart of SURVEY.md section 1):
  ops/      device operations                (ref: graphlily/hw/*)
  io/       containers, loaders, formatter   (ref: graphlily/io/*)
  module/   operation middleware             (ref: graphlily/module/*)
  apps/     BFS, SSSP, PageRank              (ref: graphlily/app/*)
  parallel/ multi-device sharding (an extension; the reference is
            single-FPGA)
  utils/    profiling, load-balance analysis, compile cache
            (ref: benchmark/analyze_*.py)
"""

from .config import EngineConfig, DEFAULT_CONFIG
from .semiring import (ArithmeticSemiring, LogicalSemiring, TropicalSemiring,
                       Semiring, MaskType, OpType, SEMIRINGS, FLOAT_INF)

__version__ = "0.1.0"
