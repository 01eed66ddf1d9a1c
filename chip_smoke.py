"""End-to-end check that graphmat runs on NVIDIA GPUs.

Drives the entry points a user calls — ``Graph`` / ``DistGraph`` and the
``run_*`` functions of ``graphmat.apps`` (which pick the engine with
``engine_for``) — at sizes graph-analytics users run, and compares every
result on the card with a plain host reference in numpy / scipy:

=========  ==============================  ===========================  ==============
phase      input                           reference                    tolerance
=========  ==============================  ===========================  ==============
pagerank   Graph500 Kronecker RMAT scale   scipy CSR power iteration,   rtol 1e-4,
           22, edgefactor 16 (~64M edges,  same formula and iteration   atol 1e-6
           4.2M vertices), seed 1          count (float64)
bfs        same graph, 4 roots             csgraph.shortest_path        depths exact;
                                           (unweighted)                 parents checked
sssp       same graph, weights in          csgraph.dijkstra             exact
           [1, 255], 1 root
sgd        1M ratings, 60K users x 20K     vectorised numpy of the      init factors
           items, K=20, 10 iterations      same update, same rand_r     bit-exact; RMSE
                                           init                         rtol 1e-4
lda        1M tokens over 30K docs x 10K   vectorised numpy of the      log-likelihood
           terms, K=20, 5 iterations       same update                  rtol 1e-4
tc         RMAT 20 (and 16)                the host count (C++ prep) at exact
                                           20; scipy (A@A)∘A at 16
=========  ==============================  ===========================  ==============

A BFS parent must be a real in-neighbour one level up.  The initial SGD
RMSE is a float32 sum taken in atomic order on the card, so it is held to
rtol 1e-6 while the factors it comes from are compared bit for bit.

Precision: the device path has no matrix product (no ``dot``, ``matmul``
or ``einsum``), so TF32 never enters.  A later change that adds one must
have its reference set ``precision="highest"``.  float32 segment sums run
on atomics on the GPU, so their order changes from run to run; that is
what the relative tolerances allow for.

Usage::

    python chip_smoke.py              # every phase above on one GPU
    python chip_smoke.py --four-gpus  # PageRank, BFS (1 root) and SGD on a
                                      # 2x2 DistGraph over four GPUs

Each phase prints one JSON line (wall time, iterations, compile time and
compile-cache hits, peak device memory); then the card's name and power
limit; then, as the last line, ``{"ok": true, "device": {...}}``.  Any
failed phase or missed comparison raises, so the exit code is non-zero and
no ``ok`` line is printed; without a GPU the script refuses to run.  One
process drives the card(s) and it starts no other.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

from graphmat import Graph
from graphmat.apps.bfs import INF_DEPTH, run_bfs
from graphmat.apps.lda import run_lda
from graphmat.apps.pagerank import run_pagerank
from graphmat.apps.sgd import init_sgd_graph, run_sgd
from graphmat.apps.sssp import INF_DIST, run_sssp
from graphmat.io.edgelist import EdgeList
from graphmat.ops.triangles import count_triangles_bucketed
from graphmat.parallel.dist_graph import DistGraph
from graphmat.parallel.mesh import factor2d, make_mesh
from graphmat.utils.compile_cache import enable_compile_cache
from graphmat.utils.generators import rmat_edgelist
from graphmat.utils.reference_rng import rand_r_uniform_np

# ----------------------------------------------------------- measurement

_COMPILE = {"s": 0.0, "hits": 0}


def _on_duration(event, duration, **_kw):
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE["s"] += duration


def _on_event(event, **_kw):
    if event == "/jax/compilation_cache/cache_hits":
        _COMPILE["hits"] += 1


jax.monitoring.register_event_duration_secs_listener(_on_duration)
jax.monitoring.register_event_listener(_on_event)


def _peak_bytes(devices=None):
    """Peak device memory so far (max over ``devices``); None where the
    backend keeps no statistics (the CPU)."""
    peaks = []
    for d in devices or jax.devices()[:1]:
        stats = d.memory_stats()
        if stats and "peak_bytes_in_use" in stats:
            peaks.append(int(stats["peak_bytes_in_use"]))
    return max(peaks) if peaks else None


class _Phase:
    """Times a phase body; collects compile seconds and cache hits."""

    def __init__(self, name, devices=None):
        self.rec = {"phase": name}
        self.devices = devices

    def __enter__(self):
        self._c0 = dict(_COMPILE)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.rec["wall_s"] = round(time.perf_counter() - self._t0, 4)
            self.rec["compile_s"] = round(_COMPILE["s"] - self._c0["s"], 4)
            self.rec["cache_hits"] = _COMPILE["hits"] - self._c0["hits"]
            self.rec["peak_bytes_in_use"] = _peak_bytes(self.devices)
        return False


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _close(got, want, rtol, atol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    _check(got.shape == want.shape and not bad.any(),
           f"{what}: {int(bad.sum())} of {want.size} entries off "
           f"(max abs err {float(err.max(initial=0)):.3g})")
    return float((err / np.maximum(np.abs(want), max(atol, 1e-30))
                  ).max(initial=0))


# ------------------------------------------------------------ references

def _csr(src0, dst0, vals, n):
    """Host adjacency A[src, dst] = val (scipy CSR)."""
    return sp.csr_matrix((np.asarray(vals, np.float64), (src0, dst0)),
                         shape=(n, n))


def pagerank_reference(src0, dst0, n, niter, alpha=0.3):
    """``pr = alpha + (1 - alpha) * A^T (pr / outdeg)`` on vertices with an
    in-edge, ``niter`` times from 0.3, in float64."""
    deg = np.bincount(src0, minlength=n).astype(np.float64)
    at = sp.csr_matrix((np.ones(len(src0)), (dst0, src0)), shape=(n, n))
    got = np.bincount(dst0, minlength=n) > 0
    pr = np.full(n, 0.3)
    for _ in range(niter):
        msg = np.where(deg > 0, pr / np.maximum(deg, 1.0), 0.0)
        pr = np.where(got, alpha + (1.0 - alpha) * (at @ msg), pr)
    return pr


def _incidence(recv, n):
    """[n, E] 0/1 matrix summing edge rows into their receivers."""
    e = len(recv)
    return sp.csr_matrix((np.ones(e), (recv, np.arange(e))), shape=(n, e))


def sgd_reference(src0, dst0, val, n, k, iters, lambda_=0.001,
                  step=3.5e-7):
    """SGD-CF (``src/SGD.cpp``) in float64 from the rand_r float32 init:
    both edge directions push ``lv_s * (rating - <lv_s, lv_r>)``."""
    lv = rand_r_uniform_np(np.arange(1, n + 1, dtype=np.uint32), k,
                           np.float32).astype(np.float64)
    val = np.asarray(val, np.float64)
    dirs = [(s, r, _incidence(r, n)) for s, r in ((src0, dst0),
                                                   (dst0, src0))]
    got = (np.bincount(src0, minlength=n) + np.bincount(dst0, minlength=n)
           ) > 0

    def rmse(lv):
        est = np.sum(lv[src0] * lv[dst0], axis=1)
        return float(np.sqrt(np.mean((val - est) ** 2)))

    r0 = rmse(lv)
    for _ in range(iters):
        grad = np.zeros_like(lv)
        for s, r, inc in dirs:
            err = val - np.sum(lv[s] * lv[r], axis=1)
            grad += inc @ (lv[s] * err[:, None])
        lv = np.where(got[:, None], lv + step * (-lambda_ * lv + grad), lv)
    return lv, r0, rmse(lv)


def lda_reference(src0, dst0, cnt, n, ndoc, nterms, k, iters, alpha=1.0,
                  eta=5.0):
    """LDA (``src/LDA.cpp``) in float64: rand_r-seeded init, ``iters``
    updates, then the total token log-likelihood."""
    val = np.asarray(cnt, np.float64)
    is_doc = np.arange(n) < ndoc
    dirs = [(s, r, _incidence(r, n)) for s, r in ((src0, dst0),
                                                   (dst0, src0))]
    got = (np.bincount(src0, minlength=n) + np.bincount(dst0, minlength=n)
           ) > 0
    gam = rand_r_uniform_np(np.asarray(cnt).astype(np.uint32), k)
    gam = gam / gam.sum(axis=1, keepdims=True) * val[:, None]
    N = np.zeros((n, k))
    for _s, _r, inc in dirs:
        N += inc @ gam
    for _ in range(iters):
        denom = N[~is_doc].sum(axis=0) + nterms * (eta - 1.0)
        new = np.zeros_like(N)
        for s, r, inc in dirs:
            my = np.where(is_doc[r], alpha, eta)[:, None]
            other = np.where(is_doc[r], eta, alpha)[:, None]
            g = (N[r] + my - 1.0) * (N[s] + other - 1.0) / denom[None, :]
            new += inc @ (g / g.sum(axis=1, keepdims=True) * val[:, None])
        N = np.where(got[:, None], new, N)
    nks = N[~is_doc].sum(axis=0) + nterms * (eta - 1.0)
    phi = (N[dst0] + eta - 1.0) / nks[None, :]
    theta = N[src0] + eta - 1.0
    theta = theta / theta.sum(axis=1, keepdims=True)
    return float(np.sum(val * np.log(np.sum(phi * theta, axis=1))))


def triangles_reference(s0, r0, n):
    """trace(A^3) / 6 of the undirected graph (scipy SpGEMM)."""
    a = sp.csr_matrix((np.ones(len(s0)), (s0, r0)), shape=(n, n))
    a = a + a.T
    return int(round((a @ a).multiply(a).sum() / 6))


# ---------------------------------------------------------------- inputs

def rmat_graph(scale, edgefactor=16, seed=1):
    """Graph500 Kronecker RMAT with integer weights in [1, 255] (PageRank
    and BFS ignore them)."""
    return rmat_edgelist(scale, edgefactor, seed=seed, weight_range=255)


def ratings(nu, ni, nr, seed=0):
    """The benchmark's rating matrix: nr (user, item, 1..5) triples."""
    rng = np.random.default_rng(seed)
    n = nu + ni
    us = rng.integers(1, nu + 1, nr).astype(np.int64)
    it = (nu + rng.integers(1, ni + 1, nr)).astype(np.int64)
    val = rng.integers(1, 6, nr).astype(np.float64)
    return EdgeList(src=us, dst=it, val=val, m=n, n=n)


def doc_terms(ndoc, nterms, ntok, seed=11):
    """The benchmark's doc-term matrix: Zipf-ish token counts."""
    rng = np.random.default_rng(seed)
    n = ndoc + nterms
    docs = rng.integers(1, ndoc + 1, ntok).astype(np.int64)
    terms = (ndoc + rng.integers(1, nterms + 1, ntok)).astype(np.int64)
    cnt = np.minimum(rng.zipf(2.0, ntok), 50).astype(np.float64)
    return EdgeList(src=docs, dst=terms, val=cnt, m=n, n=n)


def _roots(e, count, seed):
    """Graph500-style search keys: distinct vertices with out-degree >= 1
    (1-based)."""
    n = max(e.m, e.n)
    cand = np.flatnonzero(np.bincount(e.src - 1, minlength=n) > 0)
    rng = np.random.default_rng(seed)
    return [int(v) + 1 for v in rng.choice(cand, size=count, replace=False)]


# ---------------------------------------------------------------- phases

def phase_pagerank(e, graph, devices=None):
    n = max(e.m, e.n)
    with _Phase("pagerank", devices) as ph:
        pr, niter = run_pagerank(graph)
    want = pagerank_reference(e.src - 1, e.dst - 1, n, niter)
    ph.rec["iters"] = niter
    ph.rec["max_rel_err"] = _close(pr, want, 1e-4, 1e-6, "pagerank")
    return ph.rec


def phase_bfs(e, graph, roots, devices=None):
    n = max(e.m, e.n)
    a = _csr(e.src - 1, e.dst - 1, e.val, n)
    want = csgraph.shortest_path(a, directed=True, unweighted=True,
                                 indices=np.asarray(roots) - 1)
    iters = []
    with _Phase("bfs", devices) as ph:
        out = [run_bfs(graph, r) for r in roots]
    for root, ref, (depth, parent, niter) in zip(roots, want, out):
        iters.append(niter)
        ref = np.where(np.isinf(ref), INF_DEPTH, ref).astype(np.int64)
        _check(np.array_equal(depth, ref), f"bfs root {root}: depths")
        v = np.flatnonzero((depth < INF_DEPTH) & (np.arange(n) != root - 1))
        p = parent[v] - 1
        _check((p >= 0).all(), f"bfs root {root}: reached vertex without "
                               "parent")
        _check((depth[p] == depth[v] - 1).all(),
               f"bfs root {root}: parent not one level up")
        _check((np.asarray(a[p, v]).ravel() != 0).all(),
               f"bfs root {root}: parent is not an in-neighbour")
    ph.rec["iters"] = iters
    ph.rec["reached"] = [int((d < INF_DEPTH).sum()) for d, _p, _i in out]
    return ph.rec


def phase_sssp(e, graph, root):
    n = max(e.m, e.n)
    want = csgraph.dijkstra(_csr(e.src - 1, e.dst - 1, e.val, n),
                            directed=True, indices=root - 1)
    with _Phase("sssp") as ph:
        dist, niter = run_sssp(graph, root)
    want = np.where(np.isinf(want), INF_DIST, want).astype(np.int64)
    _check(np.array_equal(dist, want), "sssp: distances")
    ph.rec["iters"] = niter
    ph.rec["reached"] = int((dist < INF_DIST).sum())
    return ph.rec


def phase_sgd(el, graph, k=20, iters=10, devices=None):
    n = max(el.m, el.n)
    init_sgd_graph(graph, k)
    lv0 = rand_r_uniform_np(np.arange(1, n + 1, dtype=np.uint32), k,
                            np.float32)
    _check(np.array_equal(graph.vp_numpy()["lv"], lv0),
           "sgd: initial factors differ from rand_r")
    with _Phase("sgd", devices) as ph:
        lv, r0, r1 = run_sgd(graph, k=k, iterations=iters)
    want_lv, want_r0, want_r1 = sgd_reference(el.src - 1, el.dst - 1,
                                              el.val, n, k, iters)
    _close(r0, want_r0, 1e-6, 0.0, "sgd: initial RMSE")
    _close(r1, want_r1, 1e-4, 0.0, "sgd: final RMSE")
    ph.rec.update(iters=iters, rmse_init=r0, rmse_final=r1,
                  max_lv_rel_err=_close(lv, want_lv, 1e-4, 1e-6,
                                        "sgd: factors"))
    return ph.rec


def phase_lda(el, ndoc, nterms, k=20, iters=5):
    n = max(el.m, el.n)
    graph = Graph(el)
    with _Phase("lda") as ph:
        _N, _gn, ll = run_lda(graph, ndoc, nterms, k=k, iterations=iters)
    want = lda_reference(el.src - 1, el.dst - 1, el.val, n, ndoc, nterms,
                         k, iters)
    _close(ll, want, 1e-4, 0.0, "lda: log-likelihood")
    ph.rec.update(iters=iters, loglik=ll, loglik_reference=want)
    return ph.rec


def _undirected_pairs(e):
    """Unique undirected pairs ``s < r`` (0-based), self loops dropped."""
    n = max(e.m, e.n)
    s = np.minimum(e.src, e.dst).astype(np.int64) - 1
    r = np.maximum(e.src, e.dst).astype(np.int64) - 1
    key = np.unique(s[s != r] * n + r[s != r])
    return key // n, key % n


def phase_tc(scale=20, ref_scale=16, edgefactor=16, seed=1):
    e = rmat_graph(scale, edgefactor, seed)
    n = max(e.m, e.n)
    s0, r0 = _undirected_pairs(e)
    with _Phase("tc") as ph:
        _pv, total = count_triangles_bucketed(s0, r0, n,
                                              assume_canonical=True)
    _pv, host = count_triangles_bucketed(s0, r0, n, assume_canonical=True,
                                         impl="host")
    _check(total == host, f"tc: device {total} != host {host}")
    es = rmat_graph(ref_scale, edgefactor, seed)
    ns = max(es.m, es.n)
    s1, r1 = _undirected_pairs(es)
    _pv, small = count_triangles_bucketed(s1, r1, ns, assume_canonical=True)
    want = triangles_reference(s1, r1, ns)
    _check(small == want, f"tc: scale {ref_scale} {small} != scipy {want}")
    ph.rec.update(triangles=total, edges=int(len(s0)),
                  triangles_small=small)
    return ph.rec


def single_gpu_phases(scale=22, tc_scale=20, tc_ref_scale=16,
                      sgd=(60000, 20000, 1_000_000), lda=(30000, 10000,
                                                          1_000_000),
                      bfs_roots=4, seed=1):
    """Every one-card phase; yields one record per phase."""
    t0 = time.perf_counter()
    e = rmat_graph(scale, seed=seed)
    graph = Graph(e)
    setup_s = round(time.perf_counter() - t0, 4)
    rec = phase_pagerank(e, graph)
    rec["setup_s"] = setup_s
    yield rec
    roots = _roots(e, bfs_roots, seed)
    yield phase_bfs(e, graph, roots)
    yield phase_sssp(e, graph, roots[0])
    del graph
    el = ratings(*sgd)
    yield phase_sgd(el, Graph(el))
    yield phase_lda(doc_terms(*lda), lda[0], lda[1])
    yield phase_tc(tc_scale, tc_ref_scale, seed=seed)


def four_gpu_phases(scale=22, sgd=(60000, 20000, 1_000_000), seed=1):
    """PageRank, BFS (1 root) and SGD K=20 on 2D-sharded DistGraphs over a
    2x2 mesh of the first four devices."""
    devices = jax.devices()[:4]
    _check(len(devices) == 4, f"--four-gpus needs 4 devices, "
                              f"found {len(jax.devices())}")
    mesh = make_mesh(devices, factor2d(4))
    t0 = time.perf_counter()
    e = rmat_graph(scale, seed=seed)
    graph = DistGraph(e, mesh)
    setup_s = round(time.perf_counter() - t0, 4)
    rec = phase_pagerank(e, graph, devices)
    rec.update(setup_s=setup_s, mesh=list(mesh.devices.shape))
    yield rec
    yield phase_bfs(e, graph, _roots(e, 1, seed), devices)
    del graph
    el = ratings(*sgd)
    yield phase_sgd(el, DistGraph(el, mesh), devices=devices)


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 2x2 DistGraph phase on 4 GPUs")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py: JAX found no GPU (platform "
              f"{dev.platform!r}); refusing to run", file=sys.stderr)
        return 2
    enable_compile_cache()
    from graphmat.utils.nvml import gpu_name_power_limit
    phases = four_gpu_phases() if args.four_gpus else single_gpu_phases()
    for rec in phases:
        print(json.dumps(rec), flush=True)
    for line in gpu_name_power_limit():
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
