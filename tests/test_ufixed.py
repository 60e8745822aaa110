"""Simulated ap_ufixed<32,8,AP_RND,AP_SAT> parity mode (SURVEY §7's
"simulated-saturation mode for bit-parity experiments").

Reference datatype: graphlily/global.h:63 (val_t), hw/overlay.h:22,
UFIXED_INF = 255 at hw/math_constants.h:7. The mode rounds + saturates
arithmetic module results to the val_t grid; mid-accumulation saturation is
not simulated (the reference's own CPU oracles are float,
module/spmv_module.h:488-532)."""
import numpy as np
import jax.numpy as jnp
import pytest

from graphlily_jax.semiring import (ufixed_quantize, np_ufixed_quantize,
                                    UFIXED_MAX, UFIXED_FRAC_BITS,
                                    ArithmeticSemiring)
from graphlily_jax.config import EngineConfig
from graphlily_jax.module.spmv_module import SpMVModule
from graphlily_jax.module.apply_modules import eWiseAddModule
from graphlily_jax.io.matrix import CSRMatrix


def test_grid_constants():
    # 8 integer + 24 fractional bits, top of range = 256 - 2^-24
    assert UFIXED_FRAC_BITS == 24
    assert UFIXED_MAX == 256.0 - 2.0 ** -24


def test_np_quantize_rounds_to_grid():
    # 1/3 is not on the grid; AP_RND rounds to the nearest 2^-24 multiple
    got = np_ufixed_quantize(1.0 / 3.0)
    want = round((1.0 / 3.0) * 2**24) / 2**24
    assert got == want
    # exact grid points are fixed points of the quantizer
    v = 7 + 5 / 2**24
    assert np_ufixed_quantize(v) == v


def test_np_quantize_saturates_and_clamps():
    assert np_ufixed_quantize(300.0) == UFIXED_MAX     # AP_SAT overflow
    assert np_ufixed_quantize(1e30) == UFIXED_MAX
    assert np_ufixed_quantize(-1.0) == 0.0             # unsigned underflow
    # ties round UP (AP_RND): half an lsb rounds to a full lsb
    assert np_ufixed_quantize(0.5 / 2**24) == 1.0 / 2**24
    # sub-half-lsb values round to zero
    assert np_ufixed_quantize(0.4 / 2**24) == 0.0


def test_jnp_quantize_matches_np_in_f64_range():
    vals = np.array([0.0, 0.1, 1.0 / 3.0, 7.25, 255.0, 299.0, -3.0],
                    np.float32)
    got = np.asarray(ufixed_quantize(jnp.asarray(vals)))
    want = np_ufixed_quantize(vals).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -20)


def _csr(rows, cols, vals, n):
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, np.asarray(rows) + 1, 1)
    indptr = np.cumsum(indptr)
    order = np.lexsort((cols, rows))
    return CSRMatrix(num_rows=n, num_cols=n,
                     adj_data=np.asarray(vals, np.float32)[order],
                     adj_indices=np.asarray(cols, np.int32)[order],
                     adj_indptr=indptr.astype(np.int32))


def test_spmv_module_saturates():
    # row 0 accumulates 200*2 = 400 > 256: val_t saturates at UFIXED_MAX;
    # row 1 stays on-grid and is exact
    n = 8
    m = _csr([0, 0, 1], [0, 1, 2], [200.0, 200.0, 2.5], n)
    cfg = EngineConfig(simulate_ufixed=True)
    mod = SpMVModule(cfg)
    mod.set_semiring(ArithmeticSemiring)
    mod.load_and_format_matrix(m)
    mod.send_vector_host_to_device(np.ones(n, np.float32))
    mod.run()
    y = np.asarray(mod.results_buf.value)
    assert y[0] == np.float32(UFIXED_MAX)
    assert y[1] == np.float32(2.5)
    # same product without the mode overflows past the val_t ceiling
    mod2 = SpMVModule(EngineConfig())
    mod2.set_semiring(ArithmeticSemiring)
    mod2.load_and_format_matrix(m)
    mod2.send_vector_host_to_device(np.ones(n, np.float32))
    mod2.run()
    assert np.asarray(mod2.results_buf.value)[0] == 400.0


def test_ewise_add_saturates():
    cfg = EngineConfig(simulate_ufixed=True)
    mod = eWiseAddModule(cfg)
    mod.send_in_host_to_device(np.array([250.0, 1.0], np.float32))
    mod.run(length=2, val=10.0)
    y = mod.send_out_device_to_host()
    assert y[0] == np.float32(UFIXED_MAX)
    assert y[1] == np.float32(11.0)
