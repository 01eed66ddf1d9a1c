"""BFS / SSSP / DeltaStepping / TopologicalSort tests.

Mirrors ``test/test_bfs.cpp`` (graph families with closed-form answers)
plus scipy oracles for shortest paths.
"""

import numpy as np
import pytest
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import breadth_first_order, dijkstra

from graphmat import Graph
from graphmat.apps.bfs import INF_DEPTH, run_bfs
from graphmat.apps.delta_stepping import run_delta_stepping
from graphmat.apps.sssp import INF_DIST, run_sssp
from graphmat.apps.topological_sort import (INF_ORDER,
                                            run_topological_sort)
from graphmat.io.edgelist import EdgeList
from graphmat.utils.generators import (chain_edgelist,
                                       circular_chain_edgelist,
                                       random_edgelist,
                                       upper_triangular_edgelist)


def scipy_depths(e: EdgeList, source1: int) -> np.ndarray:
    n = max(e.m, e.n)
    a = coo_matrix((np.ones(e.nnz), (e.src - 1, e.dst - 1)), shape=(n, n))
    d = dijkstra(a.tocsr(), directed=True, indices=source1 - 1,
                 unweighted=True)
    out = np.full(n, INF_DEPTH, np.int64)
    out[np.isfinite(d)] = d[np.isfinite(d)].astype(np.int64)
    return out


def scipy_distances(e: EdgeList, source1: int) -> np.ndarray:
    n = max(e.m, e.n)
    a = coo_matrix((e.val.astype(np.float64), (e.src - 1, e.dst - 1)),
                   shape=(n, n))
    d = dijkstra(a.tocsr(), directed=True, indices=source1 - 1)
    out = np.full(n, INF_DIST, np.int64)
    out[np.isfinite(d)] = d[np.isfinite(d)].astype(np.int64)
    return out


# ----------------------------------------------------------------- BFS

@pytest.mark.parametrize("source", [1, 5])
@pytest.mark.parametrize("gen", [
    lambda: chain_edgelist(17),
    lambda: circular_chain_edgelist(12),
    lambda: random_edgelist(80, 3, seed=1),
    lambda: upper_triangular_edgelist(16),
])
def test_bfs_depths_match_scipy(gen, source):
    e = gen()
    depth, parent, _ = run_bfs(Graph(e, build_in_edges=False), source)
    np.testing.assert_array_equal(depth, scipy_depths(e, source))


def test_bfs_chain_exact():
    n = 33
    depth, parent, niter = run_bfs(Graph(chain_edgelist(n),
                                         build_in_edges=False), 1)
    np.testing.assert_array_equal(depth, np.arange(n))
    # parent of vertex i (1-based) is i-1; source parent stays -1
    np.testing.assert_array_equal(parent[1:], np.arange(1, n))
    assert parent[0] == -1


def test_bfs_parents_valid():
    e = random_edgelist(60, 4, seed=3)
    depth, parent, _ = run_bfs(Graph(e, build_in_edges=False), 1)
    edges = e.as_records()
    for v in range(60):
        if depth[v] not in (0, INF_DEPTH):
            p = parent[v]
            assert depth[p - 1] == depth[v] - 1
            assert any((p, v + 1, w) in edges for w in (1,))


def _whiskered_edgelist(seed=11, n_core=40, n_whisker=5, wlen=9):
    """A random core with long in-degree-1 whisker chains hanging off it
    (+ one detached in-degree-1 cycle) — the shape that makes
    level-synchronous BFS take many near-empty levels."""
    e = random_edgelist(n_core, 4, seed=seed)
    src = list(e.src)
    dst = list(e.dst)
    nid = n_core
    rng = np.random.default_rng(seed)
    for w in range(n_whisker):
        at = int(rng.integers(1, n_core + 1))
        prev = at
        for _ in range(wlen):
            nid += 1
            src.append(prev)
            dst.append(nid)
            prev = nid
        # whisker tail points BACK into the core (a directed chain on a
        # core-core path, the case chain contraction must not lose)
        src.append(prev)
        dst.append(int(rng.integers(1, n_core + 1)))
    # pure in-degree-1 cycle, entered from the core (no shortcut
    # possible for its members; original edges must still resolve them)
    c0 = nid + 1
    for k in range(4):
        src.append(c0 + k)
        dst.append(c0 + (k + 1) % 4)
    src.append(1)
    dst.append(c0)
    nid = c0 + 3
    n = nid
    return EdgeList(src=np.array(src, np.int64),
                    dst=np.array(dst, np.int64),
                    val=np.ones(len(src), np.float64), m=n, n=n)


@pytest.mark.parametrize("permute", [False, "degree"])
@pytest.mark.parametrize("source", [1, 43])
def test_bfs_fast_matches_classic(permute, source):
    """Shortcut-augmented packed-key BFS: depths identical to classic
    BFS, parents a valid BFS tree, fewer iterations on whisker-heavy
    graphs."""
    from graphmat.apps.bfs import build_bfs_shortcuts, run_bfs_fast
    e = _whiskered_edgelist()
    d_ref = scipy_depths(e, source)

    e_aug, pred0, ind1 = build_bfs_shortcuts(e)
    assert len(e_aug.src) > len(e.src), "no shortcuts built"
    g = Graph(e_aug, build_in_edges=False, permute=permute)
    depth, parent, niter = run_bfs_fast(g, source, pred0, ind1)
    np.testing.assert_array_equal(depth, d_ref)

    # parents: valid BFS tree over the ORIGINAL edges
    edges = set(zip(e.src.tolist(), e.dst.tolist()))
    for v in range(e.n):
        if depth[v] in (0, INF_DEPTH):
            assert parent[v] == -1
        else:
            p = int(parent[v])
            assert p >= 1 and depth[p - 1] == depth[v] - 1, (v, p)
            assert (p, v + 1) in edges, (p, v + 1)

    # the whole point: fewer iterations than the classic level loop
    _, _, it_classic = run_bfs(Graph(e, build_in_edges=False), source)
    assert niter <= it_classic


def _early_delivery_edgelist():
    """Shortcut edges deliver a NON-final key early: z is reached at
    sweep 2 with depth 4 via the whisker shortcut, then improved to its
    true depth 3 at sweep 3 via the plain path — after a sweep where
    EVERY vertex is already visited.  The graph that separates the exact
    ``key_depth <= it`` receiver-finality condition from the plausible
    but WRONG ``visited`` one."""
    #        s(1) -> c1(2) -> c2(3) -> z(7)      (plain path, depth 3)
    #        s(1) -> w1(4) -> w2(5) -> w3(6) -> z(7)   (whisker chain)
    #        w1(4) -> c2(3)   (second in-edge: keeps c2 an ANCHOR, so
    #                          no shortcut reaches it early — its depth-3
    #                          message to z lands a sweep AFTER z is
    #                          first visited at depth 4 via w3's shortcut)
    src = np.array([1, 2, 3, 1, 4, 5, 6, 4], np.int64)
    dst = np.array([2, 3, 7, 4, 5, 6, 7, 3], np.int64)
    return EdgeList(src=src, dst=dst, val=np.ones(8, np.float64),
                    m=7, n=7)


# ---------------------------------------------------------------- SSSP

@pytest.mark.parametrize("gen,source", [
    (lambda: chain_edgelist(20, weight=3), 1),
    (lambda: random_edgelist(70, 4, seed=2, weight_range=10), 1),
    (lambda: random_edgelist(70, 4, seed=5, weight_range=31), 7),
])
def test_sssp_matches_dijkstra(gen, source):
    e = gen()
    dist, _ = run_sssp(Graph(e, build_in_edges=False), source)
    np.testing.assert_array_equal(dist, scipy_distances(e, source))


def test_sssp_unreachable_stays_inf():
    e = chain_edgelist(10)
    dist, _ = run_sssp(Graph(e, build_in_edges=False), 5)
    assert (dist[:4] == INF_DIST).all()
    np.testing.assert_array_equal(dist[4:], np.arange(6))


# ------------------------------------------------------- DeltaStepping

@pytest.mark.parametrize("delta", [1, 4, 100])
def test_delta_stepping_matches_dijkstra(delta):
    e = random_edgelist(60, 4, seed=9, weight_range=10)
    dist, nbuckets = run_delta_stepping(e, delta, 1)
    np.testing.assert_array_equal(dist, scipy_distances(e, 1))
    assert nbuckets >= 1


def test_delta_stepping_matches_sssp_fixture():
    from graphmat import load_edgelist
    from graphmat.io.transforms import random_edge_weights
    e = random_edge_weights(load_edgelist("data/test.bin.mtx"), 7, seed=2)
    d1, _ = run_sssp(Graph(e, build_in_edges=False), 1)
    d2, _ = run_delta_stepping(e, 3, 1)
    np.testing.assert_array_equal(d1, d2)


# ----------------------------------------------------- TopologicalSort

def test_toposort_chain():
    n = 12
    order, has_cycle, _ = run_topological_sort(Graph(chain_edgelist(n)))
    assert not has_cycle
    np.testing.assert_array_equal(order, np.arange(n))


def test_toposort_dag_valid():
    e = upper_triangular_edgelist(15)
    g = Graph(e)
    order, has_cycle, _ = run_topological_sort(g)
    assert not has_cycle
    # every edge goes from lower to strictly higher order
    for s, d, _v in e.as_records():
        assert order[s - 1] < order[d - 1]


def test_toposort_random_dag():
    from graphmat.io.transforms import convert_to_upper_triangular
    e = convert_to_upper_triangular(random_edgelist(50, 4, seed=4))
    order, has_cycle, _ = run_topological_sort(Graph(e))
    assert not has_cycle
    for s, d, _v in e.as_records():
        assert order[s - 1] < order[d - 1]


def test_toposort_detects_cycle():
    order, has_cycle, _ = run_topological_sort(
        Graph(circular_chain_edgelist(8)))
    assert has_cycle
    assert (order == INF_ORDER).all()


# ------------------------------------------------ ConnectedComponents

def test_connected_components_matches_scipy():
    from scipy.sparse.csgraph import connected_components as cc_scipy
    from graphmat.apps.connected_components import \
        run_connected_components
    e = random_edgelist(120, 2, seed=33)
    n = max(e.m, e.n)
    a = coo_matrix((np.ones(e.nnz), (e.src - 1, e.dst - 1)), shape=(n, n))
    ncomp_ref, labels_ref = cc_scipy(a, directed=False)

    labels, ncomp, _ = run_connected_components(Graph(e))
    assert ncomp == ncomp_ref
    # same partition (label values differ: ours are min vertex ids)
    for comp in range(ncomp_ref):
        members = np.where(labels_ref == comp)[0]
        assert np.unique(labels[members]).size == 1


def test_connected_components_two_islands():
    from graphmat.apps.connected_components import \
        run_connected_components
    from graphmat.io.edgelist import edgelist_from_arrays
    e = edgelist_from_arrays([1, 2, 4, 5], [2, 3, 5, 6], m=6, n=6)
    labels, ncomp, _ = run_connected_components(Graph(e))
    assert ncomp == 2
    assert labels[0] == labels[1] == labels[2] == 1
    assert labels[3] == labels[4] == labels[5] == 4
