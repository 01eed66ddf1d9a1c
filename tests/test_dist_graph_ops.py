"""Distributed whole-graph ops vs the single-device semantics.

Mirrors test_graph_ops.py (the reference's test_apply_edges.cpp
``val == src + 5*dst`` check) on the 2D-sharded DistGraph over the
virtual 8-device mesh.
"""

import numpy as np
import pytest

import jax

from graphmat.parallel.dist_graph import DistGraph
from graphmat.parallel.dist_graph_ops import (apply_reduce_all_vertices,
                                              apply_to_all_edges,
                                              apply_to_all_vertices)
from graphmat.parallel.mesh import make_mesh
from graphmat.utils.generators import random_edgelist


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:8], (2, 4))


def make_dist_graph(mesh, n=60, deg=4, seed=5):
    e = random_edgelist(n, deg, seed=seed)
    g = DistGraph(e, mesh, seg_align=8)
    g.init_vertexproperty(val=np.arange(1, g.n + 1, dtype=np.int32))
    return g, e


def test_dist_apply_to_all_vertices(mesh):
    g, _ = make_dist_graph(mesh)
    apply_to_all_vertices(g, lambda vp: {"val": vp["val"] * 2})
    np.testing.assert_array_equal(g.vp_numpy()["val"],
                                  2 * np.arange(1, g.n + 1))


def test_dist_apply_reduce(mesh):
    g, _ = make_dist_graph(mesh)
    n = g.n
    out = apply_reduce_all_vertices(g, lambda vp: {"v": vp["val"]}, "sum")
    assert int(out["v"]) == n * (n + 1) // 2
    out = apply_reduce_all_vertices(g, lambda vp: {"v": vp["val"]}, "min")
    assert int(out["v"]) == 1
    out = apply_reduce_all_vertices(g, lambda vp: {"v": vp["val"]}, "max")
    assert int(out["v"]) == n


def _tile_globals(g, t, s_loc, r_loc):
    C, S = g.C, g.S
    ti, tj = t // C, t % C
    s_glob = ((s_loc // S) * C + tj) * S + (s_loc % S)
    r_glob = ti * (C * S) + r_loc
    return s_glob, r_glob


def test_dist_apply_to_all_edges(mesh):
    g, e = make_dist_graph(mesh)
    apply_to_all_edges(g, lambda vs, vd, val: vs["val"] + 5 * vd["val"])
    expect = {(s, d): s + 5 * d
              for s, d in zip(e.src.astype(int), e.dst.astype(int))}

    # device tiles (both orderings) carry the rewritten values
    for recv, tiles in (("dst", g.out_tiles), ("src", g.in_tiles)):
        send_is_src = recv == "dst"
        sa = np.asarray(tiles.senders)
        ra = np.asarray(tiles.receivers)
        va = np.asarray(tiles.vals)
        ok = np.asarray(tiles.valid)
        checked = 0
        for t in range(sa.shape[0]):
            m = ok[t]
            s_glob, r_glob = _tile_globals(g, t, sa[t][m].astype(np.int64),
                                           ra[t][m].astype(np.int64))
            src1 = (s_glob if send_is_src else r_glob) + 1
            dst1 = (r_glob if send_is_src else s_glob) + 1
            for s, d, v in zip(src1, dst1, va[t][m]):
                assert v == expect[(int(s), int(d))]
                checked += 1
        assert checked == e.nnz

    # host tile copies (plan inputs) updated consistently
    for recv, tiles in g._host_tiles.items():
        send_is_src = recv == "dst"
        for t, (s_loc, r_loc, v) in enumerate(tiles):
            s_glob, r_glob = _tile_globals(g, t, s_loc, r_loc)
            src1 = (s_glob if send_is_src else r_glob) + 1
            dst1 = (r_glob if send_is_src else s_glob) + 1
            for s, d, vv in zip(src1, dst1, v):
                assert vv == expect[(int(s), int(d))]


def test_dist_share_vertex_property(mesh):
    """Two DistGraphs over the same mesh alias one property store
    (DeltaStepping's light/heavy split, Graph.h:301-305)."""
    g1, _ = make_dist_graph(mesh, seed=5)
    g2, _ = make_dist_graph(mesh, seed=6)
    g2.share_vertex_property(g1)
    apply_to_all_vertices(g2, lambda vp: {"val": vp["val"] + 7})
    np.testing.assert_array_equal(g1.vp_numpy()["val"],
                                  np.arange(1, g1.n + 1) + 7)
    g1.set_vertexproperty(3, val=999)
    assert g2.get_vertexproperty(3)["val"] == 999


def test_dist_delta_stepping_matches_dijkstra(mesh):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra
    from graphmat.apps.delta_stepping import (INF_DIST,
                                              run_delta_stepping_dist)
    e = random_edgelist(50, 4, seed=11, weight_range=9)
    dist, _ = run_delta_stepping_dist(e, 3, 1, mesh, seg_align=8)
    n = max(e.m, e.n)
    a = coo_matrix((e.val, (e.src - 1, e.dst - 1)), shape=(n, n)).tocsr()
    ref = dijkstra(a, directed=True, indices=0)
    ref_i = np.where(np.isfinite(ref), ref, INF_DIST).astype(np.int64)
    np.testing.assert_array_equal(dist[:n], ref_i)


def test_dist_toposort_via_polymorphic_runner(mesh):
    """run_topological_sort works unchanged on a DistGraph (engine_for)."""
    from graphmat.apps.topological_sort import run_topological_sort
    from graphmat.utils.generators import upper_triangular_edgelist
    from graphmat.core.graph import Graph
    e = upper_triangular_edgelist(20)
    g = DistGraph(e, mesh, seg_align=8)
    order_d, cyc_d, _ = run_topological_sort(g)
    order_s, cyc_s, _ = run_topological_sort(Graph(e))
    n = max(e.m, e.n)
    np.testing.assert_array_equal(order_d[:n], order_s[:n])
    assert cyc_d == cyc_s == False  # noqa: E712


def test_dist_incremental_pagerank_runner(mesh):
    from graphmat.apps.incremental_pagerank import run_incremental_pagerank
    from graphmat.apps.pagerank import run_pagerank
    from graphmat.core.graph import Graph
    e = random_edgelist(50, 4, seed=2)
    pr, _ = run_pagerank(Graph(e))
    g = DistGraph(e, mesh, seg_align=8)
    dpr, _ = run_incremental_pagerank(g)
    n = max(e.m, e.n)
    np.testing.assert_allclose(np.asarray(dpr[:n], np.float64),
                               np.asarray(pr[:n], np.float64), atol=5e-4)


def test_dist_connected_components_runner(mesh):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as scipy_cc
    from graphmat.apps.connected_components import \
        run_connected_components
    e = random_edgelist(40, 2, seed=8)
    g = DistGraph(e, mesh, seg_align=8)
    labels, _ncomp, _ = run_connected_components(g)
    n = max(e.m, e.n)
    a = coo_matrix((np.ones(e.nnz), (e.src - 1, e.dst - 1)), shape=(n, n))
    _, ref = scipy_cc(a, directed=True, connection="weak")
    # same partition (labels may differ by renaming)
    import itertools
    for i, j in itertools.combinations(range(n), 2):
        assert (labels[i] == labels[j]) == (ref[i] == ref[j])


def test_dist_get_edges_roundtrip(mesh):
    """SpMat::get_edges analog: the DistGraph exports the ingested edge
    list back exactly (order-insensitive)."""
    e = random_edgelist(45, 3, seed=4)
    g = DistGraph(e, mesh, seg_align=8)
    out = g.get_edges()
    assert out.as_records() == e.as_records()
