"""SGD-CF, LDA, IncrementalPageRank, TriangleCounting tests.

Oracles: per-edge numpy reimplementations of the reference math
(independent of the JAX engine), plus closed-form invariants.
"""

import numpy as np
import pytest

from graphmat import Graph, load_edgelist
from graphmat.apps.incremental_pagerank import run_incremental_pagerank
from graphmat.apps.pagerank import run_pagerank
from graphmat.apps.sgd import run_sgd
from graphmat.apps.lda import run_lda
from graphmat.apps.triangle_counting import run_triangle_counting
from graphmat.io.transforms import convert_to_upper_triangular
from graphmat.utils.generators import random_edgelist, \
    upper_triangular_edgelist
from graphmat.utils.reference_rng import rand_r_uniform_np


# ------------------------------------------------------------ rand_r

def test_rand_r_matches_glibc_vectors():
    """Golden values computed with glibc rand_r (C, seed fixed)."""
    # seed=1: glibc rand_r sequence starts 476707713, 1186278907, 505671508
    out = np.asarray(rand_r_uniform_np(np.array([1], np.uint32), 3)
                     * (2 ** 31 - 1)).round().astype(np.int64)
    assert out[0].tolist() == [476707713, 1186278907, 505671508]


def test_rand_r_jnp_matches_np():
    import jax.numpy as jnp
    from graphmat.utils.reference_rng import rand_r_jnp
    seeds = np.array([1, 2, 3, 12345], np.uint32)
    a = rand_r_uniform_np(seeds, 5, np.float32)
    b = np.asarray(rand_r_jnp(jnp.asarray(seeds), 5))
    np.testing.assert_allclose(a, b, rtol=1e-6)


# ---------------------------------------------------------------- SGD

def sgd_oracle(e, k, lambda_, step, iters):
    """Per-edge numpy oracle of src/SGD.cpp semantics (float32)."""
    n = max(e.m, e.n)
    lv = rand_r_uniform_np(np.arange(1, n + 1, dtype=np.uint32), k,
                           np.float32)
    src, dst, val = e.src - 1, e.dst - 1, e.val.astype(np.float32)

    def rmse(lv):
        est = np.sum(lv[src] * lv[dst], axis=1)
        return float(np.sqrt(np.sum((val - est) ** 2) / e.nnz))

    r0 = rmse(lv)
    for _ in range(iters):
        grad = np.zeros_like(lv)
        got = np.zeros(n, bool)
        # both directions (ALL_EDGES)
        for s, r in ((src, dst), (dst, src)):
            est = np.sum(lv[s] * lv[r], axis=1)
            err = (val - est)[:, None].astype(np.float32)
            np.add.at(grad, r, lv[s] * err)
            got[r] = True
        lv = np.where(got[:, None],
                      lv + np.float32(step) * (-np.float32(lambda_) * lv
                                               + grad), lv).astype(np.float32)
    return lv, r0, rmse(lv)


def test_sgd_matches_oracle_ratings7():
    e = load_edgelist("data/ratings7.bin.mtx")
    lv_o, r0_o, r1_o = sgd_oracle(e, 20, 0.001, 3.5e-7, 10)
    g = Graph(e)
    lv, r0, r1 = run_sgd(g, k=20, iterations=10)
    assert abs(r0 - r0_o) < 1e-5
    assert abs(r1 - r1_o) < 1e-5
    np.testing.assert_allclose(lv, lv_o, rtol=1e-5, atol=1e-6)


def test_sgd_reduces_rmse_with_real_step():
    """With a workable step size the RMSE must drop."""
    e = random_edgelist(40, 4, seed=6, weight_range=5)
    g = Graph(e)
    lv, r0, r1 = run_sgd(g, k=8, lambda_=0.001, step=0.01, iterations=30)
    assert r1 < r0 * 0.9


# ---------------------------------------------------------------- LDA

def lda_oracle(e, ndoc, nterms, k, iters, alpha=1.0, eta=5.0):
    """Per-edge numpy oracle of src/LDA.cpp (float32)."""
    n = max(e.m, e.n)
    src, dst, val = e.src - 1, e.dst - 1, e.val.astype(np.float32)
    is_doc = np.arange(n) < ndoc
    # init: per-edge gamma seeded by edge value, both directions alike
    gam = rand_r_uniform_np(e.val.astype(np.uint32), k, np.float32)
    gam = gam / gam.sum(axis=1, keepdims=True) * val[:, None]
    N = np.zeros((n, k), np.float32)
    for s, r in ((src, dst), (dst, src)):
        np.add.at(N, r, gam)
    got0 = np.zeros(n, bool)
    got0[np.concatenate([src, dst])] = True
    N = np.where(got0[:, None], N, 0)

    for _ in range(iters):
        gN = N[~is_doc & (np.arange(n) < n)].sum(axis=0)
        newN = np.zeros_like(N)
        for s, r in ((src, dst), (dst, src)):
            my = np.where(is_doc[r], alpha, eta)[:, None].astype(np.float32)
            ot = np.where(is_doc[r], eta, alpha)[:, None].astype(np.float32)
            gamma = (N[r] + my - 1.0) * (N[s] + ot - 1.0) / \
                (gN + nterms * (eta - 1.0))[None, :]
            gamma = gamma / gamma.sum(axis=1, keepdims=True) * val[:, None]
            np.add.at(newN, r, gamma.astype(np.float32))
        N = np.where(got0[:, None], newN, N).astype(np.float32)
    return N


def bipartite_edges(ndoc, nterms, seed=0, maxcount=5):
    rng = np.random.default_rng(seed)
    src, dst, val = [], [], []
    for d in range(1, ndoc + 1):
        terms = rng.choice(nterms, size=rng.integers(1, nterms + 1),
                           replace=False)
        for t in terms:
            src.append(d)
            dst.append(ndoc + 1 + int(t))
            val.append(int(rng.integers(1, maxcount + 1)))
    from graphmat import edgelist_from_arrays
    n = ndoc + nterms
    return edgelist_from_arrays(src, dst, val, m=n, n=n)


def test_lda_matches_oracle():
    ndoc, nterms, k = 6, 9, 4
    e = bipartite_edges(ndoc, nterms, seed=11)
    expect = lda_oracle(e, ndoc, nterms, k, iters=5)
    g = Graph(e)
    N, gN, ll = run_lda(g, ndoc, nterms, k=k, iterations=5)
    np.testing.assert_allclose(N, expect, rtol=2e-4, atol=2e-4)
    # token counts are conserved: per-vertex N sums to its token total
    tok = np.zeros(ndoc + nterms)
    for s, d, v in zip(e.src - 1, e.dst - 1, e.val):
        tok[s] += v
        tok[d] += v
    np.testing.assert_allclose(N.sum(axis=1), tok, rtol=1e-3)
    assert np.isfinite(ll)


# --------------------------------------------------- TriangleCounting

def count_triangles_oracle(e):
    """Brute force on the undirected support of an upper-tri edge list."""
    adj = set()
    n = max(e.m, e.n)
    for s, d, _ in e.as_records():
        adj.add((s, d))
    total = 0
    import itertools
    nodes = sorted({v for p in adj for v in p})
    for a, b, c in itertools.combinations(nodes, 3):
        if (a, b) in adj and (b, c) in adj and (a, c) in adj:
            total += 1
    return total


def test_triangles_complete_graph():
    n = 10
    e = upper_triangular_edgelist(n)
    tri, total = run_triangle_counting(Graph(e))
    assert total == n * (n - 1) * (n - 2) // 6


def test_triangles_random():
    e = convert_to_upper_triangular(random_edgelist(25, 5, seed=13))
    tri, total = run_triangle_counting(Graph(e))
    assert total == count_triangles_oracle(e)


def test_triangles_fixture_2_10():
    e = load_edgelist("data/2_10_upper_triangle.bin.mtx")
    tri, total = run_triangle_counting(Graph(e))
    # invariant: recompute with scipy masked SpGEMM: tr(A·A∘A)
    from scipy.sparse import coo_matrix
    n = max(e.m, e.n)
    a = coo_matrix((np.ones(e.nnz), (e.src - 1, e.dst - 1)),
                   shape=(n, n)).tocsr()
    expect = int((a @ a).multiply(a).sum())
    assert total == expect


# ------------------------------------------- IncrementalPageRank

def test_incremental_pagerank_close_to_pagerank():
    """Delta-PR converges to the same fixpoint as standard PR."""
    e = random_edgelist(50, 4, seed=21)
    g1 = Graph(e)
    pr, _ = run_pagerank(g1)
    g2 = Graph(e)
    dpr, niter = run_incremental_pagerank(g2)
    np.testing.assert_allclose(dpr, pr, atol=5e-4)
    assert niter > 0


def test_triangles_bucketed_matches_engine():
    """Scalable degree-bucketed path: same totals as the engine path."""
    from graphmat.ops.triangles import count_triangles_bucketed
    for seed in (13, 99):
        e = convert_to_upper_triangular(random_edgelist(40, 6, seed=seed))
        g = Graph(e)
        _, want = run_triangle_counting(g, method="engine")
        tri, total = count_triangles_bucketed(e.src - 1, e.dst - 1,
                                              max(e.m, e.n))
        assert total == want
        assert int(tri.sum()) == want


def test_triangles_bucketed_fixture_2_10():
    from graphmat.ops.triangles import count_triangles_bucketed
    e = load_edgelist("data/2_10_upper_triangle.bin.mtx")
    g = Graph(e)
    tri, total = run_triangle_counting(g, method="bucketed")
    from scipy.sparse import coo_matrix
    n = max(e.m, e.n)
    a = coo_matrix((np.ones(e.nnz), (e.src - 1, e.dst - 1)),
                   shape=(n, n)).tocsr()
    expect = int((a @ a).multiply(a).sum())
    assert total == expect
    assert int(tri[:n].sum()) == expect


def test_triangles_bucketed_hubs_and_duplicates():
    """Power-law degrees; duplicate and self edges must be ignored.
    Runs both the default (whole graph in core: bitmap-only) and a
    forced-small core that exercises the tail broadcast path."""
    from graphmat.ops.triangles import count_triangles_bucketed, _prep
    rng = np.random.default_rng(5)
    n, m = 1500, 60000
    s = rng.integers(0, n, m)
    r = (rng.zipf(1.4, m) - 1) % n
    s = np.r_[s, s[:500], np.arange(50)]       # dupes + self loops
    r = np.r_[r, r[:500], np.arange(50)]
    A = np.zeros((n, n), bool)
    keep = s != r
    A[s[keep], r[keep]] = True
    A[r[keep], s[keep]] = True
    Ai = A.astype(np.int64)
    want = int(np.trace(Ai @ Ai @ Ai) // 6)
    tri, total = count_triangles_bucketed(s, r, n)
    assert total == want
    assert int(np.asarray(tri).sum()) == want
    # a small core forces tail-list groups (part 2) to carry real work
    _dev, aux = _prep(s, r, n, h=64)
    assert aux["n_groups"] >= 1
    tri2, total2 = count_triangles_bucketed(s, r, n, h=64)
    assert total2 == want
    assert int(np.asarray(tri2).sum()) == want


def test_triangles_device_prep_matches_host():
    """The fully on-device prep (impl='device', the default) and the
    native/numpy host prep agree — totals and per-vertex counts — across
    canonical and raw inputs and forced core sizes."""
    from graphmat.ops.triangles import count_triangles_bucketed
    rng = np.random.default_rng(3)
    n, m = 900, 12000
    s = rng.integers(0, n, m)
    r = rng.integers(0, n, m)
    s = np.r_[s, np.arange(30)]                # self loops
    r = np.r_[r, np.arange(30)]
    for h in (None, 64):
        tri_d, tot_d = count_triangles_bucketed(s, r, n, h=h,
                                                impl="device")
        tri_h, tot_h = count_triangles_bucketed(s, r, n, h=h,
                                                impl="host")
        assert tot_d == tot_h
        np.testing.assert_array_equal(np.asarray(tri_d),
                                      np.asarray(tri_h))
    # canonical fast path (pre-deduped a < b pairs)
    key = np.unique(np.minimum(s, r) * n + np.maximum(s, r))
    key = key[key // n != key % n]
    a, b = key // n, key % n
    tri_c, tot_c = count_triangles_bucketed(a, b, n, h=64,
                                            assume_canonical=True,
                                            impl="device")
    assert tot_c == tot_d
    np.testing.assert_array_equal(np.asarray(tri_c), np.asarray(tri_d))


def test_triangles_prep_numpy_matches_native():
    """The numpy fallback prep and the native gm_tc prep agree on the
    final counts (native may order receivers differently; totals and
    per-vertex attributions must match)."""
    import graphmat.ops.triangles as T
    from graphmat.native import native_available
    if not native_available():
        import pytest
        pytest.skip("no native planner")
    rng = np.random.default_rng(9)
    n, m = 700, 9000
    s = rng.integers(0, n, m)
    r = rng.integers(0, n, m)
    tri_nat, tot_nat = T.count_triangles_bucketed(s, r, n, h=128)
    orig = T._tc_prep_native
    try:
        T._tc_prep_native = lambda *a, **k: None
        tri_np, tot_np = T.count_triangles_bucketed(s, r, n, h=128)
    finally:
        T._tc_prep_native = orig
    assert tot_nat == tot_np
    np.testing.assert_array_equal(np.asarray(tri_nat), np.asarray(tri_np))


def test_lda_permuted_matches_oracle():
    """LDA under a degree permutation: doc/term must not be inferred
    from the internal id (rid < ndoc breaks once ids are relabeled) —
    the is_doc vertex property carries it instead."""
    ndoc, nterms, k = 6, 9, 4
    e = bipartite_edges(ndoc, nterms, seed=11)
    expect = lda_oracle(e, ndoc, nterms, k, iters=4)
    g = Graph(e, permute="degree")
    assert g.perm is not None
    N, gN, ll = run_lda(g, ndoc, nterms, k=k, iterations=4)
    np.testing.assert_allclose(N, expect, rtol=2e-4, atol=2e-4)
    assert np.isfinite(ll)


def test_triangles_unpacked_edge_path():
    """n > 2^24 ships edges as [2, e] int32 (the byte packings only
    cover ids below 2^24); both upload layouts must count identically."""
    from graphmat.ops.triangles import count_triangles_bucketed
    rng = np.random.default_rng(2)
    m = 4000
    # a small clustered subgraph embedded at ids straddling 2^24
    base = (1 << 24) - 200
    s = base + rng.integers(0, 400, m)
    r = base + rng.integers(0, 400, m)
    n_big = (1 << 24) + 300                     # forces the int32 path
    tri_b, tot_b = count_triangles_bucketed(s, r, n_big)
    tri_s, tot_s = count_triangles_bucketed(s - base, r - base, 500)
    assert tot_b == tot_s
    assert int(np.asarray(tri_b)[base:base + 500].sum()) == tot_s


def test_triangles_sixbyte_edge_path():
    """2^20 < n <= 2^24 ships 6-byte planes; n <= 2^20 ships the 5-byte
    nibble-shared layout.  A subgraph straddling 2^20 (hi nibbles
    exercised on both endpoints) must count identically through both."""
    from graphmat.ops.triangles import count_triangles_bucketed
    rng = np.random.default_rng(3)
    m = 4000
    base = (1 << 20) - 200
    s = base + rng.integers(0, 400, m)
    r = base + rng.integers(0, 400, m)
    n_mid = (1 << 20) + 300                     # forces the 6-byte path
    tri_b, tot_b = count_triangles_bucketed(s, r, n_mid)
    # shifted down: ids < 2^20 with nonzero hi nibbles -> 5-byte path
    tri_s, tot_s = count_triangles_bucketed(s - 4096, r - 4096,
                                            (1 << 20) - 3000)
    assert tot_b == tot_s
    assert int(np.asarray(tri_b)[base:base + 500].sum()) == tot_s
