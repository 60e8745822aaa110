"""App-level integration tests — counterpart of the reference's
tests/test_app.cpp: BFS pull/push/pull_push, SSSP pull/push/pull_push,
PageRank pull, each against the app's CPU reference (the reference uses
uniform_10K_10; scaled down here). Graph fixtures: uniform random, a
power-law RMAT, and a graph with isolated vertices, none with dimensions
that are multiples of 1024."""
import numpy as np
import pytest

from graphlily_jax import EngineConfig
from graphlily_jax.apps import BFS, SSSP, PageRank
from graphlily_jax.io import uniform_csr, rmat_csr, csr_from_coo

CFG = EngineConfig()
NUM_ITER = 6


def _isolated_graph():
    """2500 vertices; 2000..2499 have no edges in or out."""
    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(2000), 5)
    cols = rng.integers(0, 2000, rows.size)
    return csr_from_coo(rows, cols, rng.random(rows.size).astype(np.float32),
                        2500, 2500)


GRAPHS = {
    "uniform": lambda: uniform_csr(1200, 1200, 10, seed=42),
    "rmat": lambda: rmat_csr(3000, 30000, seed=43),
    "isolated": _isolated_graph,
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


@pytest.fixture(scope="module")
def bfs_app(graph):
    app = BFS(CFG)
    app.load_and_format_matrix(graph)
    app.send_matrix_host_to_device()
    return app


@pytest.fixture(scope="module")
def sssp_app(graph):
    app = SSSP(CFG)
    app.load_and_format_matrix(graph)
    app.send_matrix_host_to_device()
    return app


def test_bfs_pull(bfs_app):
    got = bfs_app.pull(0, NUM_ITER)
    want = bfs_app.compute_reference_results(0, NUM_ITER)
    np.testing.assert_array_equal(got, want)


def test_bfs_push(bfs_app):
    got = bfs_app.push(0, NUM_ITER)
    want = bfs_app.compute_reference_results(0, NUM_ITER)
    np.testing.assert_array_equal(got, want)


def test_bfs_pull_push(bfs_app):
    got = bfs_app.pull_push(0, NUM_ITER, threshold=0.1)
    want = bfs_app.compute_reference_results(0, NUM_ITER)
    np.testing.assert_array_equal(got, want)


def test_sssp_pull(sssp_app):
    got = sssp_app.pull(0, NUM_ITER)
    want = sssp_app.compute_reference_results(0, NUM_ITER)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sssp_push(sssp_app):
    got = sssp_app.push(0, NUM_ITER)
    want = sssp_app.compute_reference_results(0, NUM_ITER)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sssp_pull_push(sssp_app):
    got = sssp_app.pull_push(0, NUM_ITER, threshold=0.1)
    want = sssp_app.compute_reference_results(0, NUM_ITER)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pagerank_pull(graph):
    app = PageRank(CFG)
    app.load_and_format_matrix(graph, damping=0.9)
    app.send_matrix_host_to_device()
    got = app.pull(0.9, 10)
    want = app.compute_reference_results(0.9, 10)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6)


def test_bfs_chained_matches_fused(bfs_app):
    fused = bfs_app.pull(3, 4)
    chained = bfs_app.pull(3, 4, chained=True)
    np.testing.assert_allclose(fused, chained, atol=1e-4)
    fused_p = bfs_app.push(3, 4)
    chained_p = bfs_app.push(3, 4, chained=True)
    np.testing.assert_allclose(fused_p, chained_p, atol=1e-4)


def test_apps_with_degree_sort_relabeling(graph):
    """config.sort_rows_by_degree relabels vertices internally; results must
    come back in the original vertex numbering."""
    cfg = EngineConfig(sort_rows_by_degree=True)
    app = BFS(cfg)
    app.load_and_format_matrix(graph)
    got = app.pull_push(5, 5, threshold=0.1)
    ref_app = BFS(CFG)
    ref_app.load_and_format_matrix(graph)
    want = ref_app.compute_reference_results(5, 5)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # relabeled oracle agrees too
    np.testing.assert_allclose(app.compute_reference_results(5, 5), want,
                               atol=1e-4)
    pr = PageRank(cfg)
    pr.load_and_format_matrix(graph, damping=0.9)
    got = pr.pull(0.9, 5)
    pr2 = PageRank(CFG)
    pr2.load_and_format_matrix(graph, damping=0.9)
    np.testing.assert_allclose(got, pr2.compute_reference_results(0.9, 5),
                               rtol=2e-3, atol=1e-7)


def test_bfs_time_breakdown_matches_fused(graph):
    """Instrumented pull_push (reference app/bfs.h:222-347 counterpart):
    same distances as the fused loop, phases and iteration counts recorded."""
    app = BFS(CFG)
    app.load_and_format_matrix(graph)
    bd = app.pull_push_time_breakdown(3, 5, threshold=0.05)
    fused = app.pull_push(3, 5, threshold=0.05)
    np.testing.assert_allclose(bd["distance"], fused, atol=1e-4)
    assert bd["push_iterations"] + bd["pull_iterations"] == 5
    assert "push_spmspv" in bd["phases_ms"]
    assert bd["pull_iterations"] == 0 or "pull_spmv" in bd["phases_ms"]
    assert bd["total_ms"] > 0


def test_pagerank_time_breakdown_matches_pull(graph):
    """Instrumented pull (reference app/pagerank.h:93-147 counterpart):
    same ranks as the fused loop, spmv/ewise phases recorded per iter."""
    app = PageRank(CFG)
    app.load_and_format_matrix(graph, damping=0.9)
    bd = app.pull_time_breakdown(0.9, 6)
    fused = app.pull(0.9, 6)
    np.testing.assert_allclose(bd["rank"], fused, rtol=2e-3, atol=1e-7)
    assert bd["iterations"] == 6
    assert bd["calls"] == {"spmv": 6, "ewise_add": 6}
    assert set(bd["phases_ms"]) == {"spmv", "ewise_add"}
    assert bd["total_ms"] > 0


def test_sssp_time_breakdown_matches_fused(graph):
    from graphlily_jax.apps import SSSP
    app = SSSP(CFG)
    app.load_and_format_matrix(graph)
    bd = app.pull_push_time_breakdown(3, 5, threshold=0.05)
    fused = app.pull_push(3, 5, threshold=0.05)
    np.testing.assert_allclose(bd["distance"], fused, atol=1e-4)
    assert bd["push_iterations"] + bd["pull_iterations"] == 5
