"""Semiring and mask definitions for the GraphBLAS engine.

Mirrors the reference's semiring/mask model (reference: graphlily/global.h:82-107):
three semirings — arithmetic (x,+), logical (&&,||), tropical (+,min) — each a
(multiply-op, add-op, one, zero) tuple, and three mask modes.

Design differences from the reference:
  * Semirings are closed over at trace time: `Semiring.mul/add` are jnp-callables
    baked into the jitted program, not a runtime `mode` mux.
  * The tropical "infinity" is a finite sentinel (FLOAT_INF = 999999999, matching
    the reference's float flavor, graphlily/hw/math_constants.h:8) with saturating
    add, so results bit-match the reference CPU oracles
    (graphlily/module/spmspv_module.h:482-489).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import jax.numpy as jnp
import numpy as np

# Tropical-semiring "zero" (the <+>=min identity). Matches the reference's
# float configuration (graphlily/hw/math_constants.h:8, global.h:80).
FLOAT_INF = np.float32(999999999.0)
# Index sentinel used by the reference's streaming format (graphlily/hw/overlay.h:29).
# We keep it for sparse-vector parity utilities.
IDX_MARKER = np.uint32(0xFFFFFFFF)

# ---- simulated reference datatype: ap_ufixed<32, 8, AP_RND, AP_SAT> -------
# (graphlily/global.h:63, hw/overlay.h:22): 8 integer + 24 fractional bits,
# round-to-nearest on quantization (AP_RND), saturate on overflow (AP_SAT);
# domain [0, 256 - 2^-24]. The tropical flavor's UFIXED_INF is 255
# (hw/math_constants.h:7). This is SURVEY §7's "simulated-saturation mode
# for bit-parity experiments": EngineConfig.simulate_ufixed applies the
# grid to arithmetic module results (module/spmv_module.py,
# spmspv_module.py, apply_modules.py). Mid-accumulation per-PE saturation
# is NOT simulated — the reference's own CPU oracles are float too
# (module/spmv_module.h:488-532) and its tests compare with an epsilon.
UFIXED_FRAC_BITS = 24
UFIXED_MAX = float(np.float64(2**32 - 1) / np.float64(1 << UFIXED_FRAC_BITS))


def ufixed_quantize(v):
    """Round-and-saturate to the val_t grid (jnp). Exact in float64; on
    float32 the 24-bit mantissa cannot hold all 32 grid bits near the top
    of the range, so device results are best-effort on the same grid."""
    scale = jnp.asarray(1 << UFIXED_FRAC_BITS, v.dtype)
    s = jnp.floor(v * scale + jnp.asarray(0.5, v.dtype))
    s = jnp.clip(s, jnp.asarray(0.0, v.dtype),
                 jnp.asarray(float(2**32 - 1), v.dtype))
    return (s / scale).astype(v.dtype)


def np_ufixed_quantize(v):
    """Exact float64 host flavor of ufixed_quantize (for oracles/tests)."""
    v = np.asarray(v, np.float64)
    s = np.floor(v * np.float64(1 << UFIXED_FRAC_BITS) + 0.5)
    s = np.clip(s, 0.0, np.float64(2**32 - 1))
    return s / np.float64(1 << UFIXED_FRAC_BITS)


class OpType(enum.IntEnum):
    """Reference: graphlily/global.h:83-87."""

    MULADD = 0
    ANDOR = 1
    ADDMIN = 2


class MaskType(enum.IntEnum):
    """Reference: graphlily/global.h:103-107."""

    NO_MASK = 0
    WRITE_TO_ZERO = 1
    WRITE_TO_ONE = 2


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A GraphBLAS semiring: (D, mul=<x>, add=<+>, one, zero).

    `one` is the <x> identity, `zero` the <+> identity (and <x> annihilator),
    mirroring graphlily/global.h:90-95.
    """

    op: OpType
    one: float
    zero: float
    name: str = ""

    # ---- trace-time op selection ------------------------------------------
    def mul(self, a, b):
        """The semiring <x> operator (elementwise, jnp)."""
        if self.op == OpType.MULADD:
            return a * b
        if self.op == OpType.ANDOR:
            # logical and over "nonzero = true" values, result in {0,1}
            return jnp.where(
                jnp.logical_and(a != 0, b != 0),
                jnp.ones_like(a),
                jnp.zeros_like(a),
            )
        if self.op == OpType.ADDMIN:
            # saturating tropical add: INF + x = INF
            # (reference: graphlily/module/spmspv_module.h:482-489)
            s = a + b
            return jnp.minimum(s, jnp.asarray(FLOAT_INF, dtype=s.dtype))
        raise ValueError(f"invalid semiring op {self.op}")

    def add(self, a, b):
        """The semiring <+> operator (elementwise, jnp)."""
        if self.op == OpType.MULADD:
            return a + b
        if self.op == OpType.ANDOR:
            return jnp.where(
                jnp.logical_or(a != 0, b != 0),
                jnp.ones_like(a),
                jnp.zeros_like(a),
            )
        if self.op == OpType.ADDMIN:
            return jnp.minimum(a, b)
        raise ValueError(f"invalid semiring op {self.op}")

    def add_reduce(self, x, axis=None, keepdims=False):
        """<+>-reduction along an axis."""
        if self.op == OpType.MULADD:
            return jnp.sum(x, axis=axis, keepdims=keepdims)
        if self.op == OpType.ANDOR:
            s = jnp.sum(x, axis=axis, keepdims=keepdims)
            return jnp.where(s != 0, jnp.ones_like(s), jnp.zeros_like(s))
        if self.op == OpType.ADDMIN:
            return jnp.min(x, axis=axis, keepdims=keepdims)
        raise ValueError(f"invalid semiring op {self.op}")

    # numpy flavors for host-side oracles
    def np_mul(self, a, b):
        if self.op == OpType.MULADD:
            return a * b
        if self.op == OpType.ANDOR:
            return np.logical_and(a != 0, b != 0).astype(a.dtype)
        s = a + b
        return np.minimum(s, FLOAT_INF.astype(s.dtype) if hasattr(FLOAT_INF, "astype") else s.dtype.type(FLOAT_INF))

    def np_add_reduce(self, x, axis=None):
        if self.op == OpType.MULADD:
            return np.sum(x, axis=axis)
        if self.op == OpType.ANDOR:
            return (np.sum(x, axis=axis) != 0).astype(x.dtype)
        return np.min(x, axis=axis)


# The three reference semirings (graphlily/global.h:97-100).
ArithmeticSemiring = Semiring(OpType.MULADD, one=1.0, zero=0.0, name="arithmetic")
LogicalSemiring = Semiring(OpType.ANDOR, one=1.0, zero=0.0, name="logical")
TropicalSemiring = Semiring(OpType.ADDMIN, one=0.0, zero=float(FLOAT_INF), name="tropical")

SEMIRINGS = {
    "arithmetic": ArithmeticSemiring,
    "logical": LogicalSemiring,
    "tropical": TropicalSemiring,
}


def apply_mask(results, mask, mask_type: MaskType, zero):
    """Masked write-back, SpMV flavor (literal-0 comparisons and fills).

    Reference semantics (graphlily/hw/kernel_spmv_impl.h:361-385,
    graphlily/module/spmv_module.h:515-532): WRITE_TO_ZERO keeps results where
    mask==0 (else 0); WRITE_TO_ONE keeps results where mask!=0 (else 0).
    """
    del zero  # the SpMV path fills with literal 0, not the semiring zero
    if mask_type == MaskType.NO_MASK:
        return results
    if mask_type == MaskType.WRITE_TO_ZERO:
        return jnp.where(mask == 0, results, jnp.zeros_like(results))
    if mask_type == MaskType.WRITE_TO_ONE:
        return jnp.where(mask == 0, jnp.zeros_like(results), results)
    raise ValueError(f"invalid mask type {mask_type}")


def apply_mask_sparse_style(results, mask, mask_type: MaskType, zero):
    """Masked write-back, SpMSpV flavor (semiring-zero comparisons and fills).

    Reference semantics (graphlily/module/spmspv_module.h:500-517): masked-off
    entries become `semiring.zero`, and the mask is compared against
    `semiring.zero` (not literal 0).
    """
    if mask_type == MaskType.NO_MASK:
        return results
    zero_arr = jnp.asarray(zero, dtype=results.dtype)
    fill = jnp.full_like(results, zero_arr)
    if mask_type == MaskType.WRITE_TO_ONE:
        return jnp.where(mask == zero_arr, fill, results)
    if mask_type == MaskType.WRITE_TO_ZERO:
        return jnp.where(mask != zero_arr, fill, results)
    raise ValueError(f"invalid mask type {mask_type}")
