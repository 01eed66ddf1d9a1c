"""Large-graph single-device run: end-to-end PageRank / BFS / CC on an
RMAT graph — the billion-edge-class claim of the reference papers
(GraphMat README.md:72-79) scaled to one device.

Usage: SCALE=23 python scripts/bench_large.py
Env: SCALE (default 23), EDGEFACTOR (16), PR_ITERS (20).

Prints one JSON line per workload.
"""

import json
import os
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from graphmat import Graph
    from graphmat.apps.bfs import INF_DEPTH, BFSProgram, init_bfs_graph
    from graphmat.apps.connected_components import \
        ConnectedComponentsProgram
    from graphmat.apps.pagerank import (PageRankProgram,
                                        init_pagerank_graph)
    from graphmat.core.runtime import Engine
    from graphmat.utils.generators import rmat_edgelist

    scale = int(os.environ.get("SCALE", "23"))
    ef = int(os.environ.get("EDGEFACTOR", "16"))
    pr_iters = int(os.environ.get("PR_ITERS", "20"))
    # CC is ALL_EDGES -> needs the in-edge ('src') plan too; skip it at
    # the largest scale to keep both plan sets inside HBM
    run_cc = os.environ.get("RUN_CC", "1" if scale <= 23 else "0") == "1"

    t0 = time.time()
    e = rmat_edgelist(scale, ef, seed=1)
    print(f"# rmat{scale}x{ef}: nnz={e.nnz} gen={time.time()-t0:.1f}s",
          flush=True)
    t0 = time.time()
    g = Graph(e, build_in_edges=run_cc, permute="degree")
    print(f"# graph build {time.time()-t0:.1f}s n_pad={g.n_pad}",
          flush=True)
    n = max(e.m, e.n)
    deg = np.bincount(e.src - 1, minlength=n).astype(np.int32)

    # ---------------- PageRank (fixed iters, timed) ----------------
    init_pagerank_graph(g)
    gvp = dict(g.vp)
    full = np.zeros(g.n_pad, np.int32)
    if g.perm is None:
        full[:n] = deg
    else:
        full[g.perm] = deg
    gvp["degree"] = jnp.asarray(full)
    g.vp = gvp
    g.set_all_active()
    t0 = time.time()
    eng = Engine(PageRankProgram(), g)
    print(f"# engine init (plan build) {time.time()-t0:.1f}s "
          + " ".join(f"{r}:nc={p.nc},fill={p.fill:.3f}"
                     for r, p in eng._plans.items()), flush=True)
    jax.block_until_ready(list(g.vp.values()) + [g.active])
    t0 = time.time()
    eng.run(iterations=pr_iters)
    warm = time.time() - t0
    init_pagerank_graph(g)
    gvp = dict(g.vp)
    gvp["degree"] = jnp.asarray(full)
    g.vp = gvp
    g.set_all_active()
    jax.block_until_ready(list(g.vp.values()))
    t0 = time.time()
    eng.run(iterations=pr_iters)
    dt = time.time() - t0
    pr = g.vp_numpy()["pagerank"]
    assert np.isfinite(pr).all()
    print(json.dumps({
        "workload": f"pagerank_rmat{scale}", "nnz": int(g.nnz),
        "iters": pr_iters, "s_per_iter": round(dt / pr_iters, 4),
        "gteps": round(g.nnz * pr_iters / dt / 1e9, 3),
        "warmup_s": round(warm, 1)}), flush=True)

    # ---------------- BFS (until convergence) ----------------
    init_bfs_graph(g, 1)
    eng_b = Engine(BFSProgram(), g)
    t0 = time.time()
    it = eng_b.run()
    warm = time.time() - t0
    init_bfs_graph(g, 1)
    t0 = time.time()
    it = eng_b.run()
    dt = time.time() - t0
    depth = g.vp_numpy()["depth"]
    reach = int((depth != INF_DEPTH).sum())
    print(json.dumps({
        "workload": f"bfs_rmat{scale}", "iters": int(it),
        "total_s": round(dt, 3), "reached": reach,
        "gteps_per_sweep": round(g.nnz * it / dt / 1e9, 3),
        "warmup_s": round(warm, 1)}), flush=True)

    # ---------------- Connected Components (until convergence) -------
    if not run_cc:
        print('# RUN_CC=0: skipping CC at this scale', flush=True)
        return
    ids = np.arange(1, g.n + 1, dtype=np.int32)

    def init_cc():
        g.init_vertexproperty(label=ids)
        g.set_all_active()

    init_cc()
    eng_c = Engine(ConnectedComponentsProgram(), g)
    t0 = time.time()
    it = eng_c.run()
    warm = time.time() - t0
    init_cc()
    t0 = time.time()
    it = eng_c.run()
    dt = time.time() - t0
    labels = g.vp_numpy()["label"]
    ncomp = int(np.unique(labels[labels > 0]).size)
    print(json.dumps({
        "workload": f"cc_rmat{scale}", "iters": int(it),
        "total_s": round(dt, 3), "ncomp": ncomp,
        "gteps_per_sweep": round(g.nnz * it / dt / 1e9, 3),
        "warmup_s": round(warm, 1)}), flush=True)


if __name__ == "__main__":
    main()
