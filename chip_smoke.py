#!/usr/bin/env python
"""Smoke test of the whole system on one GPU, through the public API.

    python chip_smoke.py            # one card: device, ops, apps, scale
    python chip_smoke.py --multi    # four cards: the sharded path only

Every phase compares the device result with the float64 host oracles
(`compute_reference_results`) and fails the run on any mismatch:

  * logical (BFS) must match exactly;
  * tropical (SSSP) within 1e-5 relative: one f32 rounding per hop
    against the f64 oracle;
  * arithmetic (SpMV, PageRank) within 1e-4 of max|y|: f32 atomic sums
    run in no fixed order.

Graphs are the RMAT stand-ins of the ICCAD'21 evaluation graphs
(io/generate.py) at full size: googleplus (107,614 vertices, 13.67M edges)
for the ops and apps, orkut (3.07M vertices, 234.4M edges) for scale and
for the sharded path. Each phase prints its steady-state time after
compile, timed to `block_until_ready`, beside the card's name and power
limit. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
The script exits non-zero, printing no result, when JAX finds no GPU.
"""
import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np


def card_info() -> str:
    """`name, power.limit` of each card, one line per card, as nvidia-smi
    reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


class Smoke:
    def __init__(self, card: str):
        self.card = card

    def log(self, msg: str) -> None:
        print(msg, flush=True)

    def timed(self, name: str, fn, reps: int = 3):
        """Run fn once (compile + warm-up), then `reps` times; print the
        best steady-state time. Returns the last result."""
        import jax
        out = jax.block_until_ready(fn())
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            best = min(best, time.perf_counter() - t0)
        self.log(f"  {name}: {best * 1e3:.3f} ms steady-state [{self.card}]")
        return out

    @staticmethod
    def check(name: str, got, want, kind: str) -> None:
        got = np.asarray(got, np.float64)[:len(want)]
        want = np.asarray(want, np.float64)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{name}: bad shape or non-finite values")
        if kind == "logical":
            bad = int((got != want).sum())
            if bad:
                raise AssertionError(f"{name}: {bad} entries differ")
            return
        if kind == "tropical":
            err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                               1e-30)))
            if err > 1e-5:
                raise AssertionError(f"{name}: rel err {err:.3e} > 1e-5")
            return
        err = float(np.max(np.abs(got - want)))
        bound = 1e-4 * float(np.max(np.abs(want)))
        if err > bound:
            raise AssertionError(f"{name}: max err {err:.3e} > {bound:.3e}")


def phase_ops(s: Smoke, g, rng) -> None:
    import jax
    import jax.numpy as jnp
    from graphlily_jax import (ArithmeticSemiring, LogicalSemiring,
                               TropicalSemiring, MaskType)
    from graphlily_jax.io import csr2csc
    from graphlily_jax.module import (SpMVModule, SpMSpVModule,
                                      eWiseAddModule, AssignVectorDenseModule,
                                      AssignVectorSparseModule)
    from graphlily_jax.ops import sparse_from_entries, sparse_to_dense

    s.log("phase ops (googleplus)")
    mod = SpMVModule()
    mod.set_semiring(ArithmeticSemiring)
    mod.load_and_format_matrix(g)
    n = mod.get_num_rows()
    state = mod.device_state()
    mask = (rng.random(n) < 0.5).astype(np.float32)
    for sr in (ArithmeticSemiring, LogicalSemiring, TropicalSemiring):
        x = (rng.random(n) + 0.5).astype(np.float32)
        x[rng.random(n) < 0.3] = sr.zero
        for mt in MaskType:
            mod.set_semiring(sr)
            mod.set_mask_type(mt)
            f = jax.jit(lambda x_, m_, st: mod.apply(x_, m_, state=st))
            xd, md = jnp.asarray(x), jnp.asarray(mask)
            y = s.timed(f"spmv {sr.name} {mt.name}",
                        lambda: f(xd, md, state))
            s.check(f"spmv {sr.name} {mt.name}", y,
                    mod.compute_reference_results(x, mask), sr.name)
    del mod, state
    gc.collect()

    csc = csr2csc(g)
    sp = SpMSpVModule()
    sp.set_semiring(ArithmeticSemiring)
    sp.load_and_format_matrix(csc)
    sstate = sp.device_state()
    f = jax.jit(lambda sv, st: sp.apply(sv, state=st))
    for sparsity in (0.9, 0.99, 0.999):
        k = max(1, int(round(csc.num_cols * (1 - sparsity))))
        idx = np.sort(rng.choice(csc.num_cols, size=k, replace=False))
        vals = (rng.random(k) + 0.5).astype(np.float32)
        sv = sparse_from_entries(idx, vals, sp.capacity)
        out_sv, y = s.timed(f"spmspv sparsity {sparsity}",
                            lambda: f(sv, sstate))
        want = sp.compute_reference_results((idx, vals))
        s.check(f"spmspv {sparsity}", y, want, "arithmetic")
        got_sparse = np.asarray(sparse_to_dense(out_sv, sp.num_rows_, 0.0))
        s.check(f"spmspv {sparsity} sparse output", got_sparse, want,
                "arithmetic")
    del sp, sstate
    gc.collect()

    n = g.num_rows
    v = rng.random(n).astype(np.float32)
    ew = eWiseAddModule()
    ew.send_in_host_to_device(v)
    s.timed("ewise_add", lambda: (ew.run(n, 0.25), ew.out_buf.value)[1])
    s.check("ewise_add", ew.send_out_device_to_host(),
            ew.compute_reference_results(v, n, 0.25), "arithmetic")

    m = (rng.random(n) < 0.5).astype(np.float32)
    da = AssignVectorDenseModule()
    da.set_mask_type(MaskType.WRITE_TO_ONE)
    da.send_mask_host_to_device(m)
    da.send_inout_host_to_device(v)
    s.timed("assign dense", lambda: (da.run(n, 3.0), da.inout_buf.value)[1])
    want = v.astype(np.float64)
    da.compute_reference_results(m, want, n, 3.0)
    s.check("assign dense", da.send_inout_device_to_host(), want, "logical")

    idx = np.sort(rng.choice(n, size=n // 100, replace=False))
    sa = AssignVectorSparseModule(generate_new_frontier=False)
    sa.send_mask_host_to_device(
        sparse_from_entries(idx, np.ones(len(idx)), n))
    sa.send_inout_host_to_device(v)
    s.timed("assign sparse", lambda: (sa.run(2.0), sa.inout_buf.value)[1])
    want = v.astype(np.float64)
    sa.compute_reference_results_no_new_frontier(idx, want, 2.0)
    s.check("assign sparse", sa.send_inout_device_to_host(), want, "logical")


def phase_apps(s: Smoke, g, iters: int) -> None:
    from graphlily_jax.apps import BFS, SSSP, PageRank

    s.log("phase apps (googleplus)")
    bfs = BFS()
    bfs.load_and_format_matrix(g)
    s.timed("bfs pull_push", lambda: bfs.pull_push(
        0, iters, threshold=0.001, device_output=True))
    s.check("bfs pull_push", bfs.pull_push(0, iters, threshold=0.001),
            bfs.compute_reference_results(0, iters), "logical")
    del bfs
    gc.collect()

    sssp = SSSP()
    sssp.load_and_format_matrix(g)
    s.timed("sssp pull_push", lambda: sssp.pull_push(
        0, iters, threshold=0.001, device_output=True))
    s.check("sssp pull_push", sssp.pull_push(0, iters, threshold=0.001),
            sssp.compute_reference_results(0, iters), "tropical")
    del sssp
    gc.collect()

    pr = PageRank()
    pr.load_and_format_matrix(g, damping=0.9)
    s.timed("pagerank pull x10", lambda: pr.pull(0.9, 10,
                                                  device_output=True))
    s.check("pagerank pull x10", pr.pull(0.9, 10),
            pr.compute_reference_results(0.9, 10), "arithmetic")


def phase_scale(s: Smoke, g, iters: int, rng) -> None:
    import jax
    import jax.numpy as jnp
    from graphlily_jax import ArithmeticSemiring
    from graphlily_jax.apps import BFS
    from graphlily_jax.module import SpMVModule

    s.log("phase scale (orkut)")
    mod = SpMVModule()
    mod.set_semiring(ArithmeticSemiring)
    mod.load_and_format_matrix(g)
    x = rng.random(mod.get_num_cols()).astype(np.float32)
    xd, state = jnp.asarray(x), mod.device_state()
    f = jax.jit(lambda x_, st: mod.apply(x_, state=st))
    y = s.timed("spmv arithmetic", lambda: f(xd, state))
    s.check("spmv arithmetic (orkut)", y,
            mod.compute_reference_results(x), "arithmetic")
    del mod, state, xd, y
    gc.collect()

    bfs = BFS()
    bfs.load_and_format_matrix(g)
    s.timed("bfs pull_push", lambda: bfs.pull_push(
        0, iters, threshold=0.001, device_output=True))
    s.check("bfs pull_push (orkut)", bfs.pull_push(0, iters, threshold=0.001),
            bfs.compute_reference_results(0, iters), "logical")


def phase_multi(s: Smoke, g, iters: int) -> None:
    """DistSpMV and the dist_* apps on a 2x2 mesh over four cards, each
    against the single-device oracle. One sharded structure serves all
    three semirings: unit weights plus zero-weight self edges (SSSP's
    preprocessing), which change no BFS level; PageRank gets the same
    blocks with outdegree-normalized values."""
    import jax
    import jax.numpy as jnp
    from graphlily_jax import (ArithmeticSemiring, LogicalSemiring,
                               TropicalSemiring, MaskType, FLOAT_INF)
    from graphlily_jax.apps import BFS, PageRank
    from graphlily_jax.io import (util_round_csr_matrix_dim,
                                  add_self_edges_for_sssp)
    from graphlily_jax.parallel import (make_mesh, pack_sharded, DistSpMV,
                                        dist_bfs_pull, dist_bfs_pull_push,
                                        dist_sssp_pull)

    s.log("phase multi (orkut, 2x2 mesh)")
    mesh = make_mesh(4, rows=2, cols=2)
    g = g.copy()
    g.adj_data = np.ones_like(g.adj_data)
    # iterating apps need square padding to lcm(rows, cols) * 1024
    work = util_round_csr_matrix_dim(add_self_edges_for_sssp(g), 2048, 2048)
    del g
    lay = pack_sharded(work, 2, 2)
    s.log(f"  shard balance (max/avg block nnz): {lay.shard_balance:.3f}")

    # PageRank: the app's normalization (pagerank.py) of the same blocks
    outdeg = np.bincount(work.adj_indices[:work.nnz].astype(np.int64),
                         minlength=work.num_cols)
    cb = lay.local_cols
    gcol = lay.cols + (np.arange(lay.col_shards) * cb)[None, :, None]
    with np.errstate(divide="ignore"):
        inv = (1.0 / outdeg).astype(np.float32)
    pr_vals = np.where(lay.rows < lay.local_rows,
                       inv[gcol] * np.float32(0.9), np.float32(0.0))
    eng = DistSpMV(dataclasses.replace(lay, vals=pr_vals), ArithmeticSemiring,
                   mesh)
    del pr_vals, gcol
    n = eng.num_rows
    offset = np.float32(0.1 / n)
    rank = jnp.full(n, 1.0 / n, jnp.float32)
    step = jax.jit(lambda e, r: e.reshard_for_input(e(r) + offset))
    got = s.timed("dist pagerank step", lambda: step(eng, rank))
    oracle = PageRank()
    oracle.load_and_format_matrix(work, damping=0.9)
    s.check("dist pagerank step", got,
            oracle.compute_reference_results(0.9, 1), "arithmetic")
    del eng, oracle
    gc.collect()

    bfs = BFS()
    bfs.load_and_format_matrix(work)
    levels = bfs.compute_reference_results(0, iters)
    del bfs
    gc.collect()
    eng = DistSpMV(lay, LogicalSemiring, mesh,
                   mask_type=MaskType.WRITE_TO_ZERO)
    got = s.timed("dist bfs pull", lambda: dist_bfs_pull(eng, 0, iters))
    s.check("dist bfs pull", got, levels, "logical")
    got = s.timed("dist bfs pull_push", lambda: dist_bfs_pull_push(
        eng, 0, iters, threshold=0.001))
    s.check("dist bfs pull_push", got, levels, "logical")
    del eng
    gc.collect()

    # unit weights: SSSP distances are the BFS levels minus one
    eng = DistSpMV(lay, TropicalSemiring, mesh)
    got = s.timed("dist sssp pull", lambda: dist_sssp_pull(eng, 0, iters))
    s.check("dist sssp pull", got,
            np.where(levels > 0, levels - 1, float(FLOAT_INF)), "tropical")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded path, on four cards")
    args = ap.parse_args()

    import jax
    from graphlily_jax.io import iccad_standin, ICCAD_GRAPHS
    from graphlily_jax.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform})",
              file=sys.stderr)
        return 2
    need = 4 if args.multi else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    cards = card_info()
    s = Smoke(cards.splitlines()[0])
    s.log(cards)
    s.log(f"device_kind: {devices[0].device_kind}, devices: {len(devices)}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()

    if args.multi:
        orkut = iccad_standin("orkut")
        s.log(f"orkut stand-in generated in {time.perf_counter() - t0:.1f} s")
        phase_multi(s, orkut, ICCAD_GRAPHS["orkut"]["iters"])
    else:
        gplus = iccad_standin("googleplus")
        phase_ops(s, gplus, rng)
        phase_apps(s, gplus, ICCAD_GRAPHS["googleplus"]["iters"])
        del gplus
        gc.collect()
        jax.clear_caches()
        t1 = time.perf_counter()
        orkut = iccad_standin("orkut")
        s.log(f"orkut stand-in generated in {time.perf_counter() - t1:.1f} s")
        phase_scale(s, orkut, ICCAD_GRAPHS["orkut"]["iters"], rng)
    s.log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
