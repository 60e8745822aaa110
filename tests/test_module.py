"""Module middleware tests — counterpart of tests/test_module_spmv_spmspv.cpp
and tests/test_module_apply.cpp: modules vs their own CPU oracles, plus the
buffer-binding machinery (CopyBufferBindBuffer analog)."""
import numpy as np
import jax.numpy as jnp
import pytest

from graphlily_jax import (ArithmeticSemiring, LogicalSemiring,
                           TropicalSemiring, MaskType, EngineConfig)
from graphlily_jax.io import uniform_csr, csr2csc
from graphlily_jax.module import (SpMVModule, SpMSpVModule, eWiseAddModule,
                                  AssignVectorDenseModule,
                                  AssignVectorSparseModule, DeviceBuffer)
from graphlily_jax.ops import sparse_from_entries, sparse_to_dense

SEMIRINGS = [ArithmeticSemiring, LogicalSemiring, TropicalSemiring]
MASKS = [MaskType.NO_MASK, MaskType.WRITE_TO_ZERO, MaskType.WRITE_TO_ONE]
CFG = EngineConfig()


@pytest.mark.parametrize("semiring", SEMIRINGS, ids=lambda s: s.name)
@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
def test_spmv_module(semiring, mask_type, rng):
    csr = uniform_csr(500, 500, 5, seed=31)
    mod = SpMVModule(CFG)
    mod.set_semiring(semiring)
    mod.set_mask_type(mask_type)
    mod.load_and_format_matrix(csr)
    n = mod.get_num_rows()
    assert n == 1024 and mod.get_num_cols() == 1024   # rounded dims
    x = rng.random(n).astype(np.float32)
    x[rng.random(n) < 0.4] = semiring.zero
    mask = (rng.random(n) < 0.5).astype(np.float32)
    mod.send_vector_host_to_device(x[:500])  # short vector -> zero-padded
    mod.send_mask_host_to_device(mask)
    mod.run()
    got = mod.send_results_device_to_host()
    xfull = x.copy()
    xfull[500:] = semiring.zero
    want = mod.compute_reference_results(xfull, mask)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("semiring", SEMIRINGS, ids=lambda s: s.name)
@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
def test_spmspv_module(semiring, mask_type, rng):
    csr = uniform_csr(300, 300, 4, seed=32)
    csc = csr2csc(csr)
    mod = SpMSpVModule(CFG)
    mod.set_semiring(semiring)
    mod.set_mask_type(mask_type)
    mod.load_and_format_matrix(csc)
    idx = np.sort(rng.choice(300, size=40, replace=False))
    vals = rng.random(40).astype(np.float32) + 0.5
    mod.send_vector_host_to_device((idx, vals))
    mask = rng.random(300).astype(np.float32)
    mask[rng.random(300) < 0.5] = semiring.zero
    mod.send_mask_host_to_device(mask)
    mod.run()
    sv = mod.send_results_device_to_host()
    got = np.asarray(sparse_to_dense(sv, 300, semiring.zero))
    want = mod.compute_reference_results((idx, vals), mask)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert mod.get_results_nnz() == int((want != semiring.zero).sum())


@pytest.mark.parametrize("semiring", SEMIRINGS, ids=lambda s: s.name)
def test_spmspv_apply_dense_matches_sparse_api(semiring, rng):
    """The dense frontier goes straight into the gather: apply_dense on
    the scattered frontier equals the sparse API's dense result and its
    on-device nnz equals the sparse result's."""
    csc = csr2csc(uniform_csr(700, 900, 3, seed=33))
    mod = SpMSpVModule(CFG)
    mod.set_semiring(semiring)
    mod.load_and_format_matrix(csc)
    idx = np.sort(rng.choice(900, size=50, replace=False))
    sv = sparse_from_entries(idx, rng.random(50) + 0.5, mod.capacity)
    out_sv, want = mod.apply(sv)
    x = sparse_to_dense(sv, 900, semiring.zero)
    got, nnz = mod.apply_dense(x, state=mod.device_state())
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert int(nnz) == int(out_sv.nnz)


def test_buffer_binding_chain(rng):
    """The reference's CopyBufferBindBuffer test
    (tests/test_module_apply.cpp:209-261): one module's output buffer bound as
    another's input."""
    x = rng.random(64).astype(np.float32)
    ew1 = eWiseAddModule(CFG)
    ew2 = eWiseAddModule(CFG)
    ew1.send_in_host_to_device(x)
    ew2.bind_in_buf(ew1.out_buf)       # chain: ew2 reads ew1's output
    ew1.run(64, 1.0)
    ew2.run(64, 2.0)
    np.testing.assert_allclose(ew2.send_out_device_to_host(), x + 3.0,
                               rtol=1e-6)
    # copy_buffer_device_to_device
    b = DeviceBuffer()
    ew1.copy_buffer_device_to_device(ew1.out_buf, b)
    np.testing.assert_allclose(np.asarray(b.value), x + 1.0, rtol=1e-6)


def test_assign_sparse_module_modes(rng):
    inout = rng.random(50).astype(np.float32) * 10
    sv = sparse_from_entries([1, 5, 9], [2.0, 20.0, 1.0], capacity=8)
    # no-new-frontier mode requires val
    m1 = AssignVectorSparseModule(generate_new_frontier=False, config=CFG)
    m1.send_mask_host_to_device(sv)
    m1.send_inout_host_to_device(inout)
    with pytest.raises(AssertionError):
        m1.run()          # missing val
    m1.run(3.5)
    got = m1.send_inout_device_to_host()
    want = inout.copy()
    want[[1, 5, 9]] = 3.5
    np.testing.assert_array_equal(got, want)
    # new-frontier mode rejects val
    m2 = AssignVectorSparseModule(generate_new_frontier=True, config=CFG)
    m2.send_mask_host_to_device(sv)
    m2.send_inout_host_to_device(inout)
    with pytest.raises(AssertionError):
        m2.run(1.0)
    m2.run()
    got2 = m2.send_inout_device_to_host()
    nf = m2.new_frontier_buf.value
    want2 = inout.copy()
    nf_idx, nf_val = AssignVectorSparseModule.compute_reference_results_new_frontier(
        [1, 5, 9], [2.0, 20.0, 1.0], want2)
    np.testing.assert_allclose(got2, want2)
    assert int(nf.nnz) == len(nf_idx)
    np.testing.assert_array_equal(np.asarray(nf.indices[:int(nf.nnz)]), nf_idx)
