"""Distributed SpMV tests on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphlily_jax import (ArithmeticSemiring, LogicalSemiring,
                           TropicalSemiring, MaskType, EngineConfig)
from graphlily_jax.io import uniform_csr, rmat_csr
from graphlily_jax.ops import coo_from_csr, spmv_coo
from graphlily_jax.io.formatter import util_round_csr_matrix_dim
from graphlily_jax.parallel import make_mesh, DistSpMV, pack_sharded

CFG = EngineConfig()
SEMIRINGS = [ArithmeticSemiring, LogicalSemiring, TropicalSemiring]


def _single_device(csr, lay, x, semiring, mask=None,
                   mask_type=MaskType.NO_MASK):
    padded = csr.copy()
    util_round_csr_matrix_dim(padded, lay.num_rows, lay.num_cols)
    return np.asarray(spmv_coo(coo_from_csr(padded), jnp.asarray(x),
                               semiring, mask, mask_type))


@pytest.mark.parametrize("semiring", SEMIRINGS, ids=lambda s: s.name)
@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (1, 8), (2, 2), (2, 4)])
def test_dist_spmv_matches_single(semiring, shape, rng):
    R, C = shape
    mesh = make_mesh(R * C, rows=R, cols=C)
    csr = uniform_csr(3000, 3000, 5, seed=17)
    lay = pack_sharded(csr, R, C, CFG)
    eng = DistSpMV(lay, semiring, mesh, CFG)
    x = (rng.random(lay.num_cols) + 0.5).astype(np.float32)
    x[rng.random(lay.num_cols) < 0.3] = semiring.zero
    y = np.asarray(eng(jnp.asarray(x)))
    want = _single_device(csr, lay, x, semiring)
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask_type",
                         [MaskType.WRITE_TO_ZERO, MaskType.WRITE_TO_ONE],
                         ids=lambda m: m.name)
def test_dist_spmv_masked(mask_type, rng):
    mesh = make_mesh(8, rows=4, cols=2)
    csr = uniform_csr(2000, 2000, 4, seed=19)
    lay = pack_sharded(csr, 4, 2, CFG)
    eng = DistSpMV(lay, LogicalSemiring, mesh, CFG, mask_type=mask_type)
    x = (rng.random(lay.num_cols) < 0.3).astype(np.float32)
    mask = (rng.random(lay.num_rows) < 0.5).astype(np.float32)
    y = np.asarray(eng(jnp.asarray(x), jnp.asarray(mask)))
    want = _single_device(csr, lay, x, LogicalSemiring, jnp.asarray(mask),
                          mask_type)
    np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("semiring", SEMIRINGS, ids=lambda s: s.name)
def test_dist_spmv_lowers_triton_kernel_per_block(semiring):
    """Lowered for CUDA, each block's product under shard_map is the
    Triton kernel (the blocks are row-sorted); lowered for the CPU it is
    XLA's product."""
    mesh = make_mesh(4, rows=2, cols=2)
    lay = pack_sharded(uniform_csr(3000, 3000, 5, seed=17), 2, 2, CFG)
    eng = DistSpMV(lay, semiring, mesh, CFG)
    traced = jax.jit(lambda e, v: e(v)).trace(eng, jnp.ones(lay.num_cols))
    for platform, kernels in (("cuda", 1), ("cpu", 0)):
        text = traced.lower(lowering_platforms=(platform,)).as_text()
        assert text.count("__gpu$xla.gpu.triton") == kernels


def test_pack_sharded_blocks_are_local_and_row_sorted():
    """Every real entry lands in its (row-block, col-block) shard with
    block-local indices in row-ascending order; padding points past the
    block's last row."""
    csr = rmat_csr(5000, 40000, seed=13)
    lay = pack_sharded(csr, 2, 4, CFG)
    assert lay.num_rows % 2048 == 0 and lay.num_cols % 4096 == 0
    assert int(lay.block_nnz.sum()) == csr.nnz
    rb, cb = lay.local_rows, lay.local_cols
    got = []
    for i in range(2):
        for j in range(4):
            k = int(lay.block_nnz[i, j])
            r, c = lay.rows[i, j], lay.cols[i, j]
            assert (np.diff(r[:k]) >= 0).all()
            assert (r[k:] == rb).all()
            got += zip((r[:k] + i * rb).tolist(), (c[:k] + j * cb).tolist())
    want = zip(csr.row_ids().tolist(),
               csr.adj_indices[:csr.nnz].astype(np.int64).tolist())
    assert sorted(got) == sorted(want)


def test_dist_pagerank_iteration(rng):
    """One distributed power iteration inside a single jit, including the
    rows->cols reshard for the next step."""
    mesh = make_mesh(8, rows=4, cols=2)
    csr = rmat_csr(2000, 20000, seed=23)
    from graphlily_jax.io.formatter import util_normalize_csr_matrix_by_outdegree
    work = csr.copy()
    util_round_csr_matrix_dim(work, 4096, 4096)
    util_normalize_csr_matrix_by_outdegree(work)
    work.adj_data = work.adj_data * 0.9
    lay = pack_sharded(work, 4, 2, CFG)
    eng = DistSpMV(lay, ArithmeticSemiring, mesh, CFG)
    n = lay.num_rows
    offset = (1 - 0.9) / n

    @jax.jit
    def step(e, rank):
        return e.reshard_for_input(e(rank) + offset)

    rank = jnp.full(n, 1.0 / n, jnp.float32)
    r1 = np.asarray(step(eng, rank))
    coo = coo_from_csr(work)
    want = np.asarray(spmv_coo(coo, rank, ArithmeticSemiring)) + offset
    np.testing.assert_allclose(r1, want, rtol=2e-3, atol=1e-8)


def test_dist_bfs_fused_loop_matches_single_chip():
    """Multi-iteration distributed BFS (masked SpMV + stamp + reshard inside
    ONE jit) must match the single-chip BFS app's pull results."""
    from graphlily_jax.parallel import dist_bfs_pull
    from graphlily_jax.apps import BFS
    mesh = make_mesh(8, rows=4, cols=2)
    csr = uniform_csr(2048, 2048, 6, seed=23)
    csr.adj_data = np.ones_like(csr.adj_data)
    # iterating apps need square padding: lcm(4,2)*1024 on both dims
    util_round_csr_matrix_dim(csr, 4096, 4096)
    lay = pack_sharded(csr, 4, 2, CFG)
    eng = DistSpMV(lay, LogicalSemiring, mesh, CFG,
                   mask_type=MaskType.WRITE_TO_ZERO)
    got = dist_bfs_pull(eng, source=0, num_iterations=5)
    app = BFS(CFG)
    app.load_and_format_matrix(csr)
    want = app.compute_reference_results(0, 5)
    np.testing.assert_array_equal(got[:len(want)], want)


def test_dist_sssp_fused_loop_matches_single_chip():
    """Distributed tropical pull loop (pmin over cols) vs the SSSP oracle."""
    from graphlily_jax.parallel import dist_sssp_pull
    from graphlily_jax.apps import SSSP
    from graphlily_jax.io.formatter import add_self_edges_for_sssp
    mesh = make_mesh(8, rows=2, cols=4)
    csr = uniform_csr(2048, 2048, 6, seed=29)
    csr.adj_data = np.ones_like(csr.adj_data)
    prepped = add_self_edges_for_sssp(csr)
    util_round_csr_matrix_dim(prepped, 4096, 4096)
    lay = pack_sharded(prepped, 2, 4, CFG)
    eng = DistSpMV(lay, TropicalSemiring, mesh, CFG)
    got = dist_sssp_pull(eng, source=0, num_iterations=5)
    app = SSSP(CFG)
    app.load_and_format_matrix(csr)
    want = app.compute_reference_results(0, 5)
    np.testing.assert_allclose(got[:len(want)], want, rtol=1e-6)


def test_dist_tropical_engine_matches_oracle(rng):
    """Distributed tropical SpMV with random weights (pmin over 'cols') vs
    the f64 host oracle."""
    from graphlily_jax.semiring import FLOAT_INF
    mesh = make_mesh(8, rows=4, cols=2)
    csr = rmat_csr(5000, 60000, seed=23)
    csr.adj_data = (rng.random(len(csr.adj_data)) * 3).astype(np.float32)
    lay = pack_sharded(csr, 4, 2, CFG)
    eng = DistSpMV(lay, TropicalSemiring, mesh, CFG)
    x = (rng.random(lay.num_cols) * 5).astype(np.float32)
    y = np.asarray(eng(jnp.asarray(x)))
    padded = csr.copy()
    util_round_csr_matrix_dim(padded, lay.num_rows, lay.num_cols)
    rr = padded.row_ids().astype(np.int64)
    cc = padded.adj_indices[:padded.nnz].astype(np.int64)
    vv = padded.adj_data[:padded.nnz].astype(np.float64)
    want = np.full(lay.num_rows, float(FLOAT_INF))
    np.minimum.at(want, rr, np.minimum(vv + x[cc], float(FLOAT_INF)))
    np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6)


def test_dist_bfs_pull_push_matches_single_chip():
    """Distributed adaptive pull_push (do-while push + density switch in one
    jitted program over the mesh) must reproduce the single-chip fused
    app's distances exactly."""
    from graphlily_jax.apps import BFS
    from graphlily_jax.parallel import dist_bfs_pull_push
    mesh = make_mesh(8, rows=4, cols=2)
    csr = rmat_csr(3000, 24000, seed=31)
    csr.adj_data = np.ones_like(csr.adj_data)
    work = csr.copy()
    util_round_csr_matrix_dim(work, 4096, 4096)
    lay = pack_sharded(work, 4, 2, CFG)
    eng = DistSpMV(lay, LogicalSemiring, mesh, CFG,
                   mask_type=MaskType.WRITE_TO_ZERO)
    got = dist_bfs_pull_push(eng, source=2, num_iterations=5, threshold=0.05)
    app = BFS(EngineConfig(sort_rows_by_degree=False))
    app.load_and_format_matrix(work)
    want = app.pull_push(2, 5, threshold=0.05)
    np.testing.assert_array_equal(got[:len(want)], np.asarray(want))


def test_powerlaw_shard_balance_reported():
    """pack_sharded on a hub-skewed RMAT must report the pad-to-max
    stretch honestly (max/avg block nnz): RMAT hubs concentrate in the
    top-left block."""
    skew = rmat_csr(16 * 1024, 160 * 1024, seed=7, a=0.7, b=0.15, c=0.1)
    lay = pack_sharded(skew, 2, 2, CFG)
    counts = lay.block_nnz
    assert lay.shard_balance == pytest.approx(counts.max() / counts.mean())
    assert counts[0, 0] == counts.max()
    assert lay.shard_balance > 1.0


def test_dist_sssp_pull_push_skewed_matches_single_chip():
    """Fused distributed adaptive SSSP: do-while push + density switch in
    ONE jitted program over an 8-device mesh on a hub-skewed RMAT, exact
    against the single-chip fused app."""
    from graphlily_jax.apps import SSSP
    from graphlily_jax.io.formatter import add_self_edges_for_sssp
    from graphlily_jax.parallel import dist_sssp_pull_push
    mesh = make_mesh(8, rows=4, cols=2)
    csr = rmat_csr(3000, 30000, seed=41, a=0.7, b=0.15, c=0.1)  # skewed
    csr.adj_data = np.ones_like(csr.adj_data)
    work = add_self_edges_for_sssp(csr.copy())
    util_round_csr_matrix_dim(work, 4096, 4096)
    lay = pack_sharded(work, 4, 2, CFG)
    eng = DistSpMV(lay, TropicalSemiring, mesh, CFG)
    got = dist_sssp_pull_push(eng, source=2, num_iterations=5,
                              threshold=0.05)
    app = SSSP(EngineConfig(sort_rows_by_degree=False))
    app.load_and_format_matrix(csr.copy())
    want = app.pull_push(2, 5, threshold=0.05)
    np.testing.assert_array_equal(got[:len(want)], np.asarray(want))
