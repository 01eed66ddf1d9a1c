"""Multi-workload benchmark on one GPU.

Emits one JSON line per workload, then ONE final combined line whose
headline metric is PageRank GTEPS and whose ``workloads`` dict carries
the full per-workload records:

* ``pagerank``  — ⊕ = sum, dense frontier, 200 fixed iterations
  (reference: ``src/PageRank.cpp:82-112``).
* ``bfs``       — ⊕ = min, ACTIVE_ONLY frontier, until-convergence,
  chained restarts from 64 sources inside ONE dispatch (Graph500
  aggregate TEPS over traversed-component edge counts).
  Reference: ``src/BFS.cpp:83-97``.
* ``sssp``      — ⊕ = min WITH edge values, dense all-vertex
  relaxation, 200 fixed iterations (the reference's SSSP is all-active
  Bellman-Ford, ``src/SSSP.cpp:73-79``; sweeps past convergence are
  value no-ops, so distances stay correct).
* ``sgd``       — K=20 collaborative filtering, the 1M-rating protocol
  (60K users x 20K items), 60 engine iterations per dispatch + RMSE
  before/after (reference: ``src/SGD.cpp:95-117,170-200``).
* ``lda``       — K=20 topic model, 1M tokens over a 30K x 10K doc-term
  matrix, 30 iterations + log-likelihood trajectory
  (reference: ``src/LDA.cpp:263-345``).
* ``tc``        — TriangleCounting, core-bitmap device-prep path on the
  shared RMAT graph, undirected edges/s (each rep a full cold count)
  (reference: ``src/TriangleCounting.cpp:114-156``).
* ``families``  — the uniform-random family through the pagerank
  protocol, with its ratio to the RMAT headline.

Every workload reports median-of-5 with the per-rep list.  The combined
record names the device (JAX's platform, kind and count, and the card's
name and power limit).  Without a GPU the benchmark refuses to run,
unless ``JAX_PLATFORMS=cpu`` asks for a CPU rehearsal.  Any workload
that fails makes the exit code non-zero.

Env knobs: GRAPHMAT_BENCH_SCALE (default 20), GRAPHMAT_BENCH_ITERS (200),
GRAPHMAT_BENCH_EDGEFACTOR (16), GRAPHMAT_BENCH_REPS (5),
GRAPHMAT_BENCH_WORKLOADS (comma list; default all seven).
"""

import json
import os
import sys
import time
import traceback

import numpy as np

SCALE = int(os.environ.get("GRAPHMAT_BENCH_SCALE", "20"))
# 200 iterations per dispatch: the metric is sustained per-edge
# throughput, so the fixed per-dispatch host cost is amortized away
ITERS = int(os.environ.get("GRAPHMAT_BENCH_ITERS", "200"))
EDGE_FACTOR = int(os.environ.get("GRAPHMAT_BENCH_EDGEFACTOR", "16"))
REPS = int(os.environ.get("GRAPHMAT_BENCH_REPS", "5"))
BFS_SOURCES = int(os.environ.get("GRAPHMAT_BENCH_BFS_SOURCES", "64"))


def _median_reps(run_once, reps=REPS):
    rep_s = []
    for _ in range(reps):
        rep_s.append(run_once())
    return float(np.median(rep_s)), [round(t, 4) for t in rep_s]


def _base_record(metric, value, unit, config, med, rep_s, best_value):
    return {
        "metric": metric,
        "value": round(value, 4),
        "unit": unit,
        "config": config,
        "timings_s": {
            "measured_run_median": round(med, 4),
            "measured_runs": rep_s,
            "best_value": round(best_value, 4),
        },
    }


def _rmat_graph():
    """Shared RMAT fixture: (EdgeList, Graph) for pagerank + bfs (unit
    edge values; sssp rebuilds with random weights)."""
    import jax

    from graphmat import Graph
    from graphmat.utils.generators import rmat_edgelist

    t0 = time.time()
    e = rmat_edgelist(SCALE, EDGE_FACTOR, seed=1)
    gen_s = time.time() - t0
    t0 = time.time()
    g = Graph(e, build_in_edges=False, permute="degree")
    build_s = time.time() - t0
    return e, g, gen_s, build_s


def bench_pagerank(e, g):
    import jax
    import jax.numpy as jnp

    from graphmat.apps.pagerank import (PageRankProgram,
                                        init_pagerank_graph)
    from graphmat.core.runtime import Engine

    n = max(e.m, e.n)
    deg = np.bincount(e.src - 1, minlength=n).astype(np.int32)

    def setup():
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
        # sync the async H2D uploads BEFORE timing (they otherwise land
        # inside the first timed dispatch)
        jax.block_until_ready(list(g.vp.values()) + [g.active])
        float(jnp.sum(g.vp["pagerank"][:1]))

    setup()
    eng = Engine(PageRankProgram(), g)
    t0 = time.time()
    eng.run(iterations=ITERS)
    warm_s = time.time() - t0

    def once():
        setup()
        t0 = time.time()
        eng.run(iterations=ITERS)
        return time.time() - t0

    med, rep_s = _median_reps(once)
    pr = g.vp_numpy()["pagerank"]
    assert np.isfinite(pr).all(), "non-finite pagerank output"
    gteps = g.nnz * ITERS / med / 1e9
    rec = _base_record(
        "pagerank_gteps_per_chip", gteps, "GTEPS",
        {"graph": f"rmat{SCALE}x{EDGE_FACTOR}", "nnz": int(g.nnz),
         "iters": ITERS},
        med, rep_s, g.nnz * ITERS / min(rep_s) / 1e9)
    rec["timings_s"]["warmup_compile"] = round(warm_s, 2)
    return rec


def bench_bfs(e, g):
    """Graph500-style chained BFS restarts: R sources swept sequentially
    inside ONE jitted dispatch (lax.scan over sources, each an
    until-convergence lax.while_loop).

    Graph500 compliance (spec 2.1.4/5): 64 distinct search keys sampled
    uniformly from vertices with degree >= 1, and each search's edge
    count m_k is the number of input edges within the TRAVERSED
    COMPONENT (sum of out-degrees over reached vertices), not the whole
    graph's nnz — so a source that lands in a tiny component contributes
    its tiny m_k, not an inflated full-graph count.  Documented
    deviation: the spec's harmonic-mean TEPS needs per-search times,
    which a single chained device dispatch cannot observe — we report
    aggregate TEPS = sum(m_k) / total time."""
    import jax
    import jax.numpy as jnp

    from graphmat import Graph
    from graphmat.apps.bfs import (BFSFastProgram, BFSProgram,
                                   INF_DEPTH, INF_KEY, KEY_BIAS,
                                   build_bfs_shortcuts,
                                   init_bfs_graph, run_bfs)
    from graphmat.core.runtime import Engine

    # ---- kernel 1 (timed separately, reported in config): whisker
    # shortcut preprocessing + graph build over the augmented edges
    t0 = time.time()
    e_aug, pred0, ind1 = build_bfs_shortcuts(e)
    gf = Graph(e_aug, build_in_edges=False, permute="degree")
    kernel1_s = time.time() - t0
    bits = max(int(np.ceil(np.log2(gf.n_pad))), 1)
    prog = BFSFastProgram(bits)
    gf.init_vertexproperty(key=np.int32(INF_KEY))
    eng = Engine(prog, gf)
    structure = eng._structure()
    iota = jnp.arange(gf.n_pad, dtype=jnp.int32)

    # ORIGINAL out-degree plane in gf's internal order (component edge
    # counts must not include the synthetic shortcut edges)
    deg_int = np.zeros(gf.n_pad, np.int64)
    odeg = np.bincount(e.src - 1, minlength=gf.n)
    if gf.perm is None:
        deg_int[: gf.n] = odeg
    else:
        deg_int[np.asarray(gf.perm)] = odeg
    deg_plane = jnp.asarray(deg_int.astype(np.int64))
    # forced parents for shortcut targets (in-deg-1), internal order
    pred_plane_np = np.zeros(gf.n_pad, np.int64)
    ind1_plane_np = np.zeros(gf.n_pad, bool)
    if gf.perm is None:
        pred_plane_np[: gf.n] = np.maximum(pred0, 0)
        ind1_plane_np[: gf.n] = ind1
    else:
        pred_plane_np[np.asarray(gf.perm)] = np.maximum(pred0, 0)
        ind1_plane_np[np.asarray(gf.perm)] = ind1
    pred_plane = jnp.asarray(pred_plane_np.astype(np.int32))
    ind1_plane = jnp.asarray(ind1_plane_np)

    @jax.jit
    def bfs_many(structure, sources0):
        def one(carry, src0):
            vp = {"key": jnp.where(iota == src0,
                                   jnp.int32(KEY_BIAS) + src0,
                                   jnp.int32(INF_KEY))}
            active = iota == src0
            it, _st, vpo, _a, _c = eng._run_conv(
                structure, jnp.int32(0), vp, active, jnp.int32(128))
            key = vpo["key"]
            reach_mask = key < INF_KEY
            # BFS-tree output: depth + parent (shortcut winners take
            # their forced unique predecessor)
            kz = jnp.where(reach_mask, key - KEY_BIAS, 0)
            parent = jnp.where(ind1_plane, pred_plane,
                               kz & ((1 << bits) - 1))
            reached = jnp.sum(reach_mask.astype(jnp.int32))
            m_k = jnp.sum(jnp.where(reach_mask, deg_plane, 0))
            # fold parent/depth into a checksum so the tree OUTPUT stays
            # in the timed computation (not dead-code-eliminated)
            chk = jnp.max(parent) + jnp.max(kz >> bits)
            return carry + it, (it, reached, m_k, chk)
        tot, (its, reached, m_ks, _) = jax.lax.scan(
            one, jnp.int32(0), sources0)
        return tot, its, reached, m_ks

    # Graph500 kernel-2 sampling: distinct keys, degree >= 1, uniform
    rng = np.random.default_rng(7)
    cand = np.flatnonzero(np.asarray(deg_int) > 0)
    sources = jnp.asarray(
        rng.choice(cand, size=BFS_SOURCES,
                   replace=len(cand) < BFS_SOURCES).astype(np.int32))
    tot, its, reached, m_ks = jax.block_until_ready(
        bfs_many(structure, sources))

    # validation (outside timing): the classic level-synchronous BFS
    # must agree on depths for the first source
    src0_ext = (int(np.flatnonzero(np.asarray(gf.perm)
                                   == int(sources[0]))[0]) + 1
                if gf.perm is not None else int(sources[0]) + 1)
    d_ref, _p, _i = run_bfs(g, src0_ext)
    gf.init_vertexproperty(key=np.int32(INF_KEY))
    from graphmat.apps.bfs import run_bfs_fast
    d_fast, _pf, _nf = run_bfs_fast(gf, src0_ext, pred0, ind1)
    assert (d_fast == d_ref).all(), "fast BFS depths diverge from classic"

    def once():
        t0 = time.time()
        jax.block_until_ready(bfs_many(structure, sources))
        return time.time() - t0

    med, rep_s = _median_reps(once)
    its_np = np.asarray(its)
    reached_np = np.asarray(reached)
    m_np = np.asarray(m_ks, np.float64)
    assert (reached_np > 1).all(), "BFS reached nothing from a source"
    gteps = float(m_np.sum()) / med / 1e9
    return _base_record(
        "bfs_gteps_per_chip", gteps, "GTEPS",
        {"graph": f"rmat{SCALE}x{EDGE_FACTOR}", "nnz": int(g.nnz),
         "sources": BFS_SOURCES,
         "accounting": "graph500: sum of traversed-component edge "
                       "counts / total time (aggregate TEPS; harmonic "
                       "mean needs per-search host timing — see "
                       "docstring)",
         "algorithm": "packed-key min-plus with whisker shortcuts "
                      "(kernel-1 preprocessing; depths validated vs "
                      "the classic level loop)",
         "kernel1_build_s": round(kernel1_s, 2),
         "iters_per_bfs": [int(x) for x in its_np],
         "component_medges": [round(float(x) / 1e6, 2) for x in m_np],
         "reached_median": int(np.median(reached_np))},
        med, rep_s, float(m_np.sum()) / min(rep_s) / 1e9)


def bench_sssp(e):
    """⊕ = min with edge values: dense all-vertex
    Bellman-Ford relaxation sweeps, fixed ITERS (the reference's SSSP
    protocol — extra sweeps past convergence are value no-ops)."""
    import jax
    import jax.numpy as jnp

    from graphmat import Graph
    from graphmat.apps.sssp import (INF_DIST, SSSPProgram,
                                    init_sssp_graph)
    from graphmat.core.runtime import Engine
    from graphmat.core.types import Activity
    from graphmat.io.edgelist import EdgeList

    rng = np.random.default_rng(3)
    w = rng.integers(1, 256, len(e.src)).astype(np.float64)
    ew = EdgeList(src=e.src, dst=e.dst, val=w, m=e.m, n=e.n)
    g = Graph(ew, build_in_edges=False, permute="degree")

    class DenseSSSP(SSSPProgram):
        activity = Activity.ALL_VERTICES

    def setup():
        init_sssp_graph(g, 1)
        g.set_all_active()
        jax.block_until_ready(list(g.vp.values()) + [g.active])

    setup()
    eng = Engine(DenseSSSP(), g)
    eng.run(iterations=ITERS)    # compile + warm

    def once():
        setup()
        t0 = time.time()
        eng.run(iterations=ITERS)
        return time.time() - t0

    med, rep_s = _median_reps(once)
    dist = g.vp_numpy()["distance"]
    assert (dist != INF_DIST).sum() > 1, "SSSP relaxed nothing"
    gteps = g.nnz * ITERS / med / 1e9
    return _base_record(
        "sssp_gteps_per_chip", gteps, "GTEPS",
        {"graph": f"rmat{SCALE}x{EDGE_FACTOR}", "nnz": int(g.nnz),
         "iters": ITERS, "weights": "uniform int [1,255]",
         "accounting": "dense relaxation sweeps (uses edge values)",
         "reached": int((dist != INF_DIST).sum())},
        med, rep_s, g.nnz * ITERS / min(rep_s) / 1e9)


def bench_sgd():
    """SGD-CF: the 1M-rating protocol through the full engine, plus the
    BASELINE-named RMSE."""
    import jax

    from graphmat import Graph
    from graphmat.apps.sgd import (SGDProgram, init_sgd_graph,
                                   rmse_per_edge)
    from graphmat.core.runtime import Engine
    from graphmat.io.edgelist import EdgeList

    rng = np.random.default_rng(0)
    nu, ni, nr = 60000, 20000, 1_000_000
    if os.environ.get("GRAPHMAT_BENCH_SMALL"):   # CPU smoke-test sizes
        nu, ni, nr = 600, 200, 5000
    K = 20
    n = nu + ni
    us = rng.integers(1, nu + 1, nr).astype(np.int64)
    it = (nu + rng.integers(1, ni + 1, nr)).astype(np.int64)
    val = rng.integers(1, 6, nr).astype(np.float64)
    el = EdgeList(src=us, dst=it, val=val, m=n, n=n)
    g = Graph(el)
    prog = SGDProgram(k=K)

    sgd_iters = 60   # iterations per dispatch
    init_sgd_graph(g, K)
    g.set_all_active()
    rmse_before = rmse_per_edge(g, k=K)
    eng = Engine(prog, g)
    # warm with the SAME static iteration count (a different count is a
    # different executable — the first rep would measure a recompile)
    eng.run(iterations=sgd_iters)

    def once():
        init_sgd_graph(g, K)
        g.set_all_active()
        jax.block_until_ready(list(g.vp.values()))
        t0 = time.time()
        eng.run(iterations=sgd_iters)
        return time.time() - t0

    med, rep_s = _median_reps(once)
    rmse_after = rmse_per_edge(g, k=K)
    assert rmse_after < rmse_before, \
        f"SGD diverged: {rmse_before} -> {rmse_after}"
    # each rating updates both endpoints per iteration (ALL_EDGES)
    mups = 2 * nr * sgd_iters / med / 1e6
    return _base_record(
        "sgd_cf_edge_updates_per_s", mups, "M upd/s",
        {"graph": f"ratings {nu}x{ni}", "nnz": nr, "k": K,
         "iters": sgd_iters,
         "rmse_before": round(float(rmse_before), 6),
         "rmse_after": round(float(rmse_after), 6)},
        med, rep_s, 2 * nr * sgd_iters / min(rep_s) / 1e6)


def bench_lda():
    """LDA (collapsed variational analog): tokens/s over a synthetic
    doc-term matrix + the log-likelihood
    trajectory (reference: ``src/LDA.cpp:263-345``, which times the main
    iteration loop and prints the total log-likelihood)."""
    import jax
    import jax.numpy as jnp

    from graphmat import Graph
    from graphmat.apps.lda import (LDAInitProgram, LDALLProgram,
                                   LDAProgram)
    from graphmat.core.runtime import Engine
    from graphmat.io.edgelist import EdgeList

    rng = np.random.default_rng(11)
    ndoc, nterms, ntok = 30000, 10000, 1_000_000
    if os.environ.get("GRAPHMAT_BENCH_SMALL"):   # CPU smoke-test sizes
        ndoc, nterms, ntok = 300, 100, 5000
    K = 20
    n = ndoc + nterms
    docs = rng.integers(1, ndoc + 1, ntok).astype(np.int64)
    terms = (ndoc + rng.integers(1, nterms + 1, ntok)).astype(np.int64)
    # token counts follow a zipf-ish distribution like real corpora
    cnt = np.minimum(rng.zipf(2.0, ntok), 50).astype(np.float64)
    el = EdgeList(src=docs, dst=terms, val=cnt, m=n, n=n)
    g = Graph(el)
    lda_iters = 30   # iterations per dispatch

    def loglik(global_n):
        eng_ll = Engine(LDALLProgram(jnp.asarray(global_n), 5.0, nterms,
                                     K), g)
        eng_ll.run(iterations=1)
        return float(g.vp_numpy()["token_loglik"].sum())

    def setup():
        is_doc = np.zeros(n, bool)
        is_doc[:ndoc] = True
        g.init_vertexproperty(N=np.zeros((n, K), np.float32),
                              is_doc=is_doc,
                              token_loglik=np.array(0, np.float32))
        Engine(LDAInitProgram(K), g).run(iterations=1)
        vpn = g.vp_numpy()
        gn = jnp.asarray(
            vpn["N"][~vpn["is_doc"].astype(bool)].sum(axis=0), jnp.float32)
        g.set_all_active()
        jax.block_until_ready(list(g.vp.values()))
        return gn

    gn0 = setup()
    prog = LDAProgram(K, 1.0, 5.0, vocab_size=nterms)
    eng = Engine(prog, g)
    eng.run(iterations=lda_iters, state=gn0)   # compile + warm
    ll_init = loglik(gn0)

    def once():
        gn = setup()
        t0 = time.time()
        eng.run(iterations=lda_iters, state=gn)
        return time.time() - t0

    med, rep_s = _median_reps(once)
    gn_final = np.asarray(eng.final_state)
    ll_final = loglik(gn_final)
    assert np.isfinite(ll_final), "non-finite LDA log-likelihood"
    # the trajectory is recorded, not asserted monotone: on topic-free
    # random data the multiplicative update can dip slightly (the oracle
    # tests in tests/test_ml_apps.py own correctness)
    # each token is touched in both directions per iteration (ALL_EDGES)
    mtoks = 2 * ntok * lda_iters / med / 1e6
    return _base_record(
        "lda_token_updates_per_s", mtoks, "M tok/s",
        {"graph": f"docterm {ndoc}x{nterms}", "nnz": ntok, "k": K,
         "iters": lda_iters,
         "loglik_init": round(ll_init, 1),
         "loglik_final": round(ll_final, 1)},
        med, rep_s, 2 * ntok * lda_iters / min(rep_s) / 1e6)


def bench_tc(e, g):
    """TriangleCounting — edges/s on the shared RMAT graph (reference:
    ``src/TriangleCounting.cpp:114-156``).  The WHOLE prep (dedup,
    ranks, orientation, core-bitmap + tail-list build) runs on the
    device; each rep is a full cold count including the raw-edge
    upload, both jits, and the stats fetch — the analog of the
    reference's timed GetNeighbors + CountTriangles phases."""
    from graphmat.ops.triangles import count_triangles_bucketed

    und = np.unique(np.stack([np.minimum(e.src, e.dst),
                              np.maximum(e.src, e.dst)]), axis=1)
    s0 = (und[0] - 1).astype(np.int64)
    r0 = (und[1] - 1).astype(np.int64)
    keep = s0 != r0
    s0, r0 = s0[keep], r0[keep]

    tri, total = count_triangles_bucketed(
        s0, r0, g.n, assume_canonical=True)   # warm compile

    def once():
        t0 = time.time()
        _, tot = count_triangles_bucketed(s0, r0, g.n,
                                          assume_canonical=True)
        assert tot == total
        return time.time() - t0

    med, rep_s = _median_reps(once)
    assert total > 0, "no triangles on an RMAT graph"
    medges = len(s0) / med / 1e6
    return _base_record(
        "tc_edges_per_s", medges, "M edges/s",
        {"graph": f"rmat{SCALE}x{EDGE_FACTOR} undirected",
         "m_undirected": int(len(s0)), "triangles": int(total),
         "algorithm": "device-prep core-bitmap split: popcount over "
                      "packed core neighborhoods + broadcast tail "
                      "lists; prep = XLA sorts/scatters"},
        med, rep_s, len(s0) / min(rep_s) / 1e6)


def bench_families(rmat_gteps):
    """Graph-family record: the uniform-random family (no hubs) through
    the SAME engine protocol as the pagerank headline, with its ratio to
    that headline."""
    import jax
    import jax.numpy as jnp

    from graphmat import Graph
    from graphmat.apps.pagerank import (PageRankProgram,
                                        init_pagerank_graph)
    from graphmat.core.runtime import Engine
    from graphmat.io.edgelist import EdgeList

    rng = np.random.default_rng(11)
    n = 1 << SCALE
    m = EDGE_FACTOR * n
    el = EdgeList(src=rng.integers(1, n + 1, m),
                  dst=rng.integers(1, n + 1, m),
                  val=rng.integers(1, 256, m).astype(np.float64),
                  m=n, n=n)
    g = Graph(el, build_in_edges=False, permute="degree")
    deg = np.bincount(el.src - 1, minlength=n).astype(np.int32)

    def setup():
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
        jax.block_until_ready(list(g.vp.values()) + [g.active])
        float(jnp.sum(g.vp["pagerank"][:1]))

    setup()
    eng = Engine(PageRankProgram(), g)
    eng.run(iterations=ITERS)          # compile + warm

    def once():
        setup()
        t0 = time.time()
        eng.run(iterations=ITERS)
        return time.time() - t0

    med, rep_s = _median_reps(once, reps=min(REPS, 3))
    gteps = g.nnz * ITERS / med / 1e9
    ratio = gteps / rmat_gteps if rmat_gteps else 0.0
    return _base_record(
        "uniform_pagerank_gteps_per_chip", gteps, "GTEPS",
        {"graph": f"uniform {1 << SCALE} x{EDGE_FACTOR}",
         "nnz": int(g.nnz), "iters": ITERS,
         "ratio_vs_rmat_pagerank": round(ratio, 3),
         "note": "same engine protocol as the pagerank record"},
        med, rep_s, g.nnz * ITERS / min(rep_s) / 1e9)


def _device_record():
    """The device every number of this run comes from.  Refuses a run
    without a GPU unless ``JAX_PLATFORMS=cpu`` asked for a rehearsal."""
    import jax

    dev = jax.devices()[0]
    rec = {"platform": dev.platform, "kind": dev.device_kind,
           "count": len(jax.devices())}
    if dev.platform == "gpu":
        from graphmat.utils.nvml import gpu_name_power_limit
        rec["nvidia_smi"] = gpu_name_power_limit()
    elif os.environ.get("JAX_PLATFORMS", "").strip() != "cpu":
        raise SystemExit(f"bench.py: no GPU ({dev.platform} found); set "
                         "JAX_PLATFORMS=cpu for a CPU rehearsal")
    return rec


def main() -> int:
    from graphmat.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    device = _device_record()
    sel = os.environ.get("GRAPHMAT_BENCH_WORKLOADS",
                         "pagerank,bfs,sssp,sgd,lda,tc,families"
                         ).split(",")
    records = {}
    shared = {}

    def failed(name, exc):
        records[name] = {"metric": name, "value": 0.0,
                         "error": f"{type(exc).__name__}: {exc}"}
        print(json.dumps(records[name]), flush=True)

    def guarded(name, fn):
        try:
            records[name] = fn()
        except Exception as exc:
            traceback.print_exc(file=sys.stderr)
            failed(name, exc)
            return
        print(json.dumps(records[name]), flush=True)

    e = g = None
    if any(w in sel for w in ("pagerank", "bfs", "sssp", "tc")):
        try:
            e, g, gen_s, build_s = _rmat_graph()
            shared["rmat_gen"] = round(gen_s, 2)
            shared["graph_build"] = round(build_s, 2)
        except Exception as exc:
            traceback.print_exc(file=sys.stderr)
            for name in ("pagerank", "bfs", "sssp", "tc"):
                if name in sel:
                    failed(name, exc)
            sel = [s for s in sel
                   if s not in ("pagerank", "bfs", "sssp", "tc")]
    if "pagerank" in sel:
        guarded("pagerank", lambda: bench_pagerank(e, g))
    if "bfs" in sel:
        guarded("bfs", lambda: bench_bfs(e, g))
    if "sssp" in sel:
        guarded("sssp", lambda: bench_sssp(e))
    if "sgd" in sel:
        guarded("sgd", bench_sgd)
    if "lda" in sel:
        guarded("lda", bench_lda)
    if "tc" in sel:
        guarded("tc", lambda: bench_tc(e, g))
    if "families" in sel:
        guarded("families", lambda: bench_families(
            records.get("pagerank", {}).get("value", 0.0)))

    head = records.get("pagerank", {})
    errors = {k: v["error"] for k, v in records.items() if "error" in v}
    combined = {
        "metric": "pagerank_gteps_per_chip",
        "value": head.get("value", 0.0),
        "unit": "GTEPS",
        "device": device,
        "config": dict(head.get("config", {}), reps=REPS, **shared),
        "timings_s": head.get("timings_s", {}),
        "workloads": records,
    }
    if errors:
        combined["errors"] = errors
    print(json.dumps(combined), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
