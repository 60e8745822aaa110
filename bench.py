#!/usr/bin/env python
"""Benchmark harness — the reference's measurement protocol on a GPU.

Protocol (reference benchmark/, see BASELINE.md):
  * SpMV: GTEPS = nnz / avg time, arithmetic semiring, no mask, 100 runs
    (bench_spmv.cpp:96-112) — here the 100 runs are one on-device
    lax.fori_loop, so the time is the device's and not the host's dispatch.
  * PageRank: per-iteration time, damping 0.9, 10 iters (bench_pagerank.cpp).
  * BFS/SSSP: total time for the per-dataset iteration counts (run_bfs.sh:20).
  * SpMSpV: frontier-sparsity sweep, avg of 20 runs (bench_spmspv.cpp:270).

Every timing is the best of a few runs after a compile + warm-up run, each
ended by `block_until_ready`. Before any timing a correctness gate runs the
SpMV module for every semiring, unmasked and masked, against the float64
host oracle (reference: verified warm-up before timing,
benchmark/bench_spmspv.cpp:203-225).

Datasets: deterministic RMAT stand-ins at the six ICCAD'21 graph scales
(io/generate.py). vs_baseline divides SpMV GTEPS by the reference
platform's derived peak of 21.2 GTEPS (128 PEs x 166 MHz — BASELINE.md).

Each result is one JSON line on stdout, carrying the card's device_kind,
name and power limit. The script fails when JAX finds no GPU.

`--ab` instead compares the two products of row-sorted SpMV on the same
card, in one process: XLA's gather + segment reduce against the Triton
kernel (ops/spmv_triton.py) that ships on GPUs. Per graph it sweeps the
kernel's block geometry, then runs the arms in the order XLA, kernel,
kernel, XLA (SpMV per semiring as 100-call device loops, PageRank x10
through the app) and reports each arm's best run and its errors against
the float64 oracle.

Usage: python bench.py [--graphs g1,g2] [--scale S] [--skip-apps] [--ab]
"""
import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time

import numpy as np

PEAK_REFERENCE_GTEPS = 21.2  # derived U280 bound, BASELINE.md


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def best_time(fn, reps=5):
    """Compile + warm up, then the best of `reps` runs, in seconds."""
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def correctness_gate():
    """SpMV module vs the float64 oracle: 3 semirings x {no mask, masked}."""
    import jax
    import jax.numpy as jnp
    from graphlily_jax import (ArithmeticSemiring, LogicalSemiring,
                               TropicalSemiring, MaskType)
    from graphlily_jax.io import rmat_csr
    from graphlily_jax.module import SpMVModule

    rng = np.random.default_rng(11)
    mod = SpMVModule()
    mod.set_semiring(ArithmeticSemiring)
    mod.load_and_format_matrix(rmat_csr(num_rows=30000, nnz=300000, seed=17))
    n = mod.get_num_rows()
    mask = (rng.random(n) < 0.5).astype(np.float32)
    for sr in (ArithmeticSemiring, LogicalSemiring, TropicalSemiring):
        x = (rng.random(n) + 0.5).astype(np.float32)
        x[rng.random(n) < 0.3] = sr.zero
        for mt in (MaskType.NO_MASK, MaskType.WRITE_TO_ZERO):
            mod.set_semiring(sr)
            mod.set_mask_type(mt)
            f = jax.jit(lambda x_, m_, st: mod.apply(x_, m_, state=st))
            y = np.asarray(f(jnp.asarray(x), jnp.asarray(mask),
                             mod.device_state()), np.float64)
            want = mod.compute_reference_results(x, mask)
            scale = np.maximum(np.abs(want), 1e-3)
            err = float(np.max(np.abs(y - want) / scale))
            if err > 1e-4:
                raise AssertionError(f"correctness gate FAILED: {sr.name} "
                                     f"mask={mt.name} rel err {err:.3e}")
    log("correctness gate passed (6 semiring/mask combos)")


def spmv_module(csr):
    """An SpMV module on the outdegree-normalized matrix (bounded spectrum,
    so an iterated vector stays finite), and the seconds it took."""
    from graphlily_jax import ArithmeticSemiring
    from graphlily_jax.io import util_normalize_csr_matrix_by_outdegree
    from graphlily_jax.module import SpMVModule

    work = csr.copy()
    util_normalize_csr_matrix_by_outdegree(work)
    t0 = time.perf_counter()
    mod = SpMVModule()
    mod.set_semiring(ArithmeticSemiring)
    mod.load_and_format_matrix(work)
    return mod, time.perf_counter() - t0


def spmv_loop(mod, semiring, iters):
    """(compile seconds, best per-call seconds) of `iters` unmasked SpMV
    calls chained in one device loop."""
    import jax
    import jax.numpy as jnp

    mod.set_semiring(semiring)
    n = mod.get_num_rows()

    @jax.jit
    def loop(state, x):
        return jax.lax.fori_loop(
            0, iters, lambda _i, v: mod.apply(v, state=state) + 0.1 / n, x)

    x0 = jnp.full(n, 1.0 / n, jnp.float32)
    state = mod.device_state()
    t0 = time.perf_counter()
    out = np.asarray(loop(state, x0))
    compile_s = time.perf_counter() - t0
    assert np.isfinite(out).all()
    return compile_s, best_time(lambda: loop(state, x0)) / iters


def bench_spmv(csr, iters):
    """Arithmetic SpMV, no mask, on the outdegree-normalized matrix."""
    from graphlily_jax import ArithmeticSemiring

    mod, format_s = spmv_module(csr)
    compile_s, per_iter = spmv_loop(mod, ArithmeticSemiring, iters)
    gteps = csr.nnz / per_iter / 1e9
    return {"spmv_ms": per_iter * 1e3, "spmv_gteps": gteps,
            "vs_baseline": gteps / PEAK_REFERENCE_GTEPS,
            "format_s": format_s, "compile_s": compile_s,
            "timing": f"best of 5 {iters}-iteration device loops"}


def bench_spmspv_sweep(csr, sparsities=(0.9, 0.95, 0.99, 0.995, 0.999,
                                        0.9995, 0.9999)):
    """SpMSpV frontier-sparsity sweep (reference bench_spmspv.cpp:270-276,
    avg of 20 runs): the sparse API and the dense frontier the apps use."""
    import jax
    import jax.numpy as jnp
    from graphlily_jax import ArithmeticSemiring
    from graphlily_jax.io import csr2csc
    from graphlily_jax.module import SpMSpVModule
    from graphlily_jax.ops import sparse_from_entries

    csc = csr2csc(csr)
    mod = SpMSpVModule()
    mod.set_semiring(ArithmeticSemiring)
    mod.load_and_format_matrix(csc)
    n = mod.num_cols_
    deg = np.diff(csc.adj_indptr.astype(np.int64))
    state = mod.device_state()
    rng = np.random.default_rng(7)
    iters = 20

    @jax.jit
    def loop(st, sv):
        def body(_i, sv_):
            out_sv, _ = mod.apply(sv_, state=st)
            # same frontier every iteration, with a data dependency on the
            # result so the product is not eliminated
            vals = jnp.where(jnp.arange(sv_.values.shape[0]) < sv_.nnz,
                             1.0, 0.0) + out_sv.values * 0.0
            return type(sv_)(sv_.indices, vals.astype(sv_.values.dtype),
                             sv_.nnz)
        return jax.lax.fori_loop(0, iters, body, sv).values.sum()

    @jax.jit
    def loop_dense(st, x0):
        def body(_i, x_):
            y, _nnz = mod.apply_dense(x_, state=st)
            return x0 + y * 0.0
        return jax.lax.fori_loop(0, iters, body, x0).sum()

    out = {}
    for sp in sparsities:
        k = max(1, int(round(n * (1 - sp))))
        idx = np.sort(rng.choice(n, size=k, replace=False))
        sv = sparse_from_entries(idx, np.ones(k, np.float32), mod.capacity)
        dt = best_time(lambda: loop(state, sv), reps=3) / iters
        xd = np.zeros(n, np.float32)
        xd[idx] = 1.0
        xdj = jnp.asarray(xd)
        dtd = best_time(lambda: loop_dense(state, xdj), reps=3) / iters
        traversed = int(deg[idx].sum())
        out[f"sparsity_{sp}"] = {
            "ms": dt * 1e3, "dense_frontier_ms": dtd * 1e3,
            "traversed_edges": traversed,
            "gteps_traversed": traversed / dt / 1e9,
        }
    return out


def bench_apps(csr, bfs_iters):
    """PageRank x10 + BFS pull_push + SSSP pull_push, each through its
    app's fused device loop (device_output: no host fetch)."""
    from graphlily_jax.apps import BFS, SSSP, PageRank
    res = {}
    pr = PageRank()
    pr.load_and_format_matrix(csr, damping=0.9)
    res["pagerank_ms_per_iter"] = best_time(
        lambda: pr.pull(0.9, 10, device_output=True), reps=3) / 10 * 1e3
    del pr
    gc.collect()
    bfs = BFS()
    bfs.load_and_format_matrix(csr)
    dt = best_time(lambda: bfs.pull_push(0, bfs_iters, threshold=0.001,
                                         device_output=True), reps=3)
    res["bfs_pull_push_ms"] = dt * 1e3
    res["bfs_gteps"] = csr.nnz / dt / 1e9
    del bfs
    gc.collect()
    sssp = SSSP()
    sssp.load_and_format_matrix(csr)
    res["sssp_pull_push_ms"] = best_time(
        lambda: sssp.pull_push(0, bfs_iters, threshold=0.001,
                               device_output=True), reps=3) * 1e3
    return res


@contextlib.contextmanager
def product_arm(arm: str):
    """Run row-sorted products through XLA alone ("xla") or as shipped
    ("kernel": the Triton kernel when lowered for a GPU)."""
    import jax
    from graphlily_jax.ops import reference
    shipped = reference.coo_product
    if arm == "xla":
        reference.coo_product = reference.xla_product
    jax.clear_caches()
    try:
        yield
    finally:
        reference.coo_product = shipped
        jax.clear_caches()


GEOMETRIES = [(256, 1), (128, 1), (512, 2), (1024, 2), (1024, 4)]


def ab_geometry(csr, iters):
    """Per-call time of the kernel alone (a 100-call device loop) for each
    (block, warps), arithmetic and tropical, each checked against XLA's
    product on the first call."""
    import jax
    import jax.numpy as jnp
    from graphlily_jax import ArithmeticSemiring, TropicalSemiring
    from graphlily_jax.ops.reference import coo_from_csr, xla_product
    from graphlily_jax.ops.spmv_triton import spmv_triton

    coo = coo_from_csr(csr)
    n = csr.num_rows
    x0 = jnp.asarray(np.random.default_rng(3).random(n).astype(np.float32))
    out = {}
    for sr in (ArithmeticSemiring, TropicalSemiring):
        want = np.asarray(xla_product(coo, x0, sr, True), np.float64)
        for block, warps in GEOMETRIES:
            def one(c, v, sr=sr, b=block, nw=warps):
                return spmv_triton(c, v, sr, block=b, warps=nw)
            got = np.asarray(jax.jit(one)(coo, x0), np.float64)
            err = float(np.max(np.abs(got - want)
                               / np.maximum(np.abs(want), 1e-30)))
            loop = jax.jit(lambda c, v, one=one: jax.lax.fori_loop(
                0, iters, lambda _i, y: one(c, y) * 0.5 + x0, v))
            ms = best_time(lambda: loop(coo, x0), reps=3) / iters * 1e3
            out[f"{sr.name}_{block}_{warps}"] = {
                "ms": ms, "max_rel_err_vs_xla": err}
    return out


def ab(csr, iters):
    """The geometry sweep, then the arms XLA, kernel, kernel, XLA over the
    same device matrices: SpMV per semiring and PageRank x10, each the best
    of a few runs, PageRank also against its float64 oracle."""
    from graphlily_jax import (ArithmeticSemiring, LogicalSemiring,
                               TropicalSemiring)
    from graphlily_jax.apps import PageRank

    out = {"geometry": ab_geometry(csr, iters)}
    mod, _ = spmv_module(csr)
    pr = PageRank()
    pr.load_and_format_matrix(csr, damping=0.9)
    want = pr.compute_reference_results(0.9, 10)
    for i, arm in enumerate(("xla", "kernel", "kernel", "xla")):
        with product_arm(arm):
            res = {f"spmv_{sr.name}_ms": spmv_loop(mod, sr, iters)[1] * 1e3
                   for sr in (ArithmeticSemiring, LogicalSemiring,
                              TropicalSemiring)}
            res["pagerank_x10_ms"] = best_time(
                lambda: pr.pull(0.9, 10, device_output=True), reps=3) * 1e3
            err = np.abs(np.asarray(pr.pull(0.9, 10), np.float64) - want)
            res["pagerank_max_rel_err"] = float(np.max(err / np.abs(want)))
            res["pagerank_max_err_of_max"] = float(np.max(err)
                                                   / np.max(np.abs(want)))
        out[f"{i}_{arm}"] = res
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", type=str,
                    default="googleplus,ogbl_ppa,hollywood,pokec,"
                            "ogbn_products,orkut",
                    help="comma list of ICCAD'21 stand-ins")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink factor for the stand-ins (quick runs)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--skip-apps", action="store_true")
    ap.add_argument("--ab", action="store_true",
                    help="compare XLA's product with the Triton kernel")
    args = ap.parse_args()

    import jax
    from graphlily_jax.io import iccad_standin, ICCAD_GRAPHS
    from graphlily_jax.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py: no GPU (JAX platform {dev.platform})")
        return 2
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "card": card}
    correctness_gate()

    for name in args.graphs.split(","):
        gc.collect()
        jax.clear_caches()
        t0 = time.perf_counter()
        g = iccad_standin(name, scale=args.scale, seed=0)
        row = {"graph": name, "scale": args.scale, "nnz": g.nnz,
               "vertices": g.num_rows,
               "generate_s": time.perf_counter() - t0, **device}
        if args.ab:
            row.update(ab(g, args.iters))
            print(json.dumps(row), flush=True)
            continue
        row.update(bench_spmv(g, args.iters))
        if not args.skip_apps:
            row.update(bench_apps(g, ICCAD_GRAPHS[name]["iters"]))
            row["spmspv_sweep"] = bench_spmspv_sweep(g)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
