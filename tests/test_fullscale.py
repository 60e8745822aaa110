"""Big-scale CPU regression: a ~100K-vertex power-law graph through the
module + app layers, degree-sorted, with dimensions that are not multiples
of 1024. Mirrors the reference's sw_emu module run on real googleplus
(tests/test_module_spmv_spmspv.cpp:144-178) at a size the CPU finishes
quickly: ~98K rows, ~800K nnz.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from graphlily_jax import (ArithmeticSemiring, LogicalSemiring, MaskType,
                           EngineConfig)
from graphlily_jax.io import rmat_csr, csr2csc
from graphlily_jax.module import SpMVModule, SpMSpVModule
from graphlily_jax.ops import sparse_from_entries

CFG = EngineConfig(sort_rows_by_degree=True)
N = 98_000
NNZ = 800_000


@pytest.fixture(scope="module")
def big_graph():
    return rmat_csr(N, NNZ, seed=11)


def test_fullscale_spmv_module(big_graph, rng):
    """SpMV through SpMVModule at ~100K vertices vs the f64 oracle."""
    mod = SpMVModule(CFG)
    mod.set_semiring(ArithmeticSemiring)
    mod.set_mask_type(MaskType.NO_MASK)
    mod.load_and_format_matrix(big_graph)
    n = mod.get_num_rows()
    assert n == 98_304
    x = rng.random(n).astype(np.float32)
    x[rng.random(n) < 0.5] = 0.0
    mod.send_vector_host_to_device(x)
    mod.run()
    got = mod.send_results_device_to_host()
    want = mod.compute_reference_results(x, None)
    scale = np.maximum(np.abs(want), 1e-3)
    assert float(np.max(np.abs(got - want) / scale)) < 3e-2


def test_fullscale_bfs_app(big_graph):
    """BFS pull_push at ~100K vertices: the fused while_loop over the
    SpMV + SpMSpV modules vs the host oracle (the reference's googleplus
    sw_emu app check)."""
    from graphlily_jax.apps import BFS
    g = big_graph.copy()
    g.adj_data = np.ones_like(g.adj_data)
    app = BFS(CFG)
    app.load_and_format_matrix(g)
    got = app.pull_push(3, 4, threshold=0.01)
    want = app.compute_reference_results(3, 4)
    np.testing.assert_allclose(np.asarray(got)[:len(want)], want, atol=1e-5)


def test_fullscale_spmspv_module(big_graph, rng):
    """SpMSpV at ~100K vertices on a sparse frontier vs the
    active-columns oracle."""
    mod_v = SpMVModule(CFG)
    mod_v.set_semiring(ArithmeticSemiring)
    mod_v.load_and_format_matrix(big_graph)

    csc = csr2csc(mod_v.csr_matrix_)
    mod = SpMSpVModule(CFG)
    mod.set_semiring(ArithmeticSemiring)
    mod.set_mask_type(MaskType.NO_MASK)
    mod.load_and_format_matrix(csc)
    n = mod.num_cols_
    nnz_vec = 500
    idx = np.sort(rng.choice(n, size=nnz_vec, replace=False))
    vals = (rng.random(nnz_vec) + 0.5).astype(np.float32)
    sv = sparse_from_entries(idx, vals, mod.capacity, dtype=CFG.jdtype)
    out_sv, _dense = mod.apply(sv, state=mod.device_state())
    out_nnz = out_sv.nnz
    got = np.zeros(n, np.float32)
    gi = np.asarray(out_sv.indices)[:int(out_nnz)]
    gv = np.asarray(out_sv.values)[:int(out_nnz)]
    got[gi] = gv
    # f64 active-columns oracle on the same (relabeled) matrix
    work = mod_v.csr_matrix_
    rr = work.row_ids().astype(np.int64)
    cc = work.adj_indices[:work.nnz].astype(np.int64)
    vv = work.adj_data[:work.nnz].astype(np.float64)
    xd = np.zeros(work.num_cols)
    xd[idx] = vals
    want = np.zeros(work.num_rows)
    np.add.at(want, rr, vv * xd[cc])
    scale = np.maximum(np.abs(want), 1e-3)
    assert float(np.max(np.abs(got - want[:n]) / scale)) < 3e-2
