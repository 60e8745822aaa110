"""Engine configuration.

One dataclass replaces the reference's three config mechanisms — compile-time
constants in global.h:56-64, synthesizer-injected buffer sizes
(graphlily/synthesizer/overlay_synthesizer.h:35-48), and module-constructor
mirrors (graphlily/module/spmv_module.h:95-102) — eliminating the
host/device-disagreement bug class called out in SURVEY.md §5.6.

The reference's geometry knobs (NUM_HBM_CHANNEL, PACK_SIZE,
SPMV_OUT_BUF_LEN, VEC_BUF_LEN, SPMV_ROW_INTERLEAVE_FACTOR) have no
counterpart: the engine is a gather plus an atomic segment reduce over COO
arrays, and XLA picks the launch geometry. val_t = ap_ufixed<32,8> maps to
`dtype` (float32 default; `simulate_ufixed` emulates the fixed-point grid).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # --- numerics ---
    dtype: str = "float32"       # value dtype
    idx_dtype: str = "int32"
    simulate_ufixed: bool = False    # bit-parity experiment mode: round +
                                     # saturate arithmetic module results to
                                     # the reference's ap_ufixed<32,8,AP_RND,
                                     # AP_SAT> grid (graphlily/global.h:63;
                                     # see semiring.ufixed_quantize)

    # --- formatter behavior ---
    sort_rows_by_degree: bool = False  # symmetric degree-sort relabeling
    skip_empty_rows: bool = True       # parity knob (reference csr2cpsr flag)

    # --- sparse-vector (SpMSpV) static capacity ---
    # results/frontier buffers get a static capacity = num_rows (worst case) unless set
    frontier_capacity: Optional[int] = None

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    @property
    def jidx(self):
        return jnp.dtype(self.idx_dtype)


DEFAULT_CONFIG = EngineConfig()
