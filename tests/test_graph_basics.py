"""Graph construction tests — mirrors ``test/test_matrix_basics.cpp`` and
``test/test_graph_basics.cpp`` (build → get_edges round-trip, nnz, property
set/get)."""

import numpy as np
import pytest

from graphmat import Graph, load_edgelist
from graphmat.utils.generators import (chain_edgelist, dense_edgelist,
                                       identity_edgelist, random_edgelist,
                                       upper_triangular_edgelist)


@pytest.mark.parametrize("gen", [
    lambda: identity_edgelist(37),
    lambda: chain_edgelist(64),
    lambda: random_edgelist(100, 8, seed=5),
    lambda: upper_triangular_edgelist(20),
    lambda: dense_edgelist(13),
])
def test_get_edges_roundtrip(gen):
    e = gen()
    g = Graph(e)
    assert g.nnz == e.nnz
    r = g.get_edges()
    assert r.as_records() == e.as_records()


def test_roundtrip_via_in_edges():
    e = random_edgelist(60, 6, seed=2)
    g = Graph(e, build_out_edges=False)
    assert g.get_edges().as_records() == e.as_records()


def test_fixture_graph():
    e = load_edgelist("data/test.bin.mtx")
    g = Graph(e)
    assert g.n == 8 and g.nnz == 13
    assert g.get_edges().as_records() == e.as_records()


def test_vertexproperty_set_get():
    g = Graph(chain_edgelist(10))
    g.init_vertexproperty(x=np.float32(1.5), idx=np.arange(10, dtype=np.int32))
    assert g.get_vertexproperty(3)["x"] == np.float32(1.5)
    assert g.get_vertexproperty(7)["idx"] == 6
    g.set_vertexproperty(3, x=9.0)
    assert g.get_vertexproperty(3)["x"] == np.float32(9.0)
    assert g.get_vertexproperty(4)["x"] == np.float32(1.5)
    vp = g.vp_numpy()
    assert vp["x"].shape == (10,)


def test_active_management():
    g = Graph(chain_edgelist(10))
    g.set_all_active()
    assert int(np.asarray(g.active).sum()) == 10  # padding stays inactive
    g.set_all_inactive()
    g.set_active(5)
    a = np.asarray(g.active)
    assert a[4] and a.sum() == 1


def test_share_vertex_property():
    g1 = Graph(chain_edgelist(10))
    g2 = Graph(chain_edgelist(10))
    g1.init_vertexproperty(x=np.float32(0))
    g2.share_vertex_property(g1)
    g1.set_vertexproperty(2, x=5.0)
    assert g2.get_vertexproperty(2)["x"] == np.float32(5.0)
    g2.set_vertexproperty(3, x=7.0)
    assert g1.get_vertexproperty(3)["x"] == np.float32(7.0)


def test_share_vertex_property_rejects_mismatched_perm():
    """Two permute='degree' graphs over different edge subsets derive
    different permutations — sharing must fail loudly, and succeed when
    the second graph reuses the first one's perm (ADVICE r3)."""
    from graphmat.io.edgelist import EdgeList
    e = random_edgelist(60, 4, seed=42)
    half = EdgeList(src=e.src[::2], dst=e.dst[::2],
                    val=e.val[::2] if e.val is not None else None,
                    m=e.m, n=e.n)
    g1 = Graph(e, permute="degree")
    g2 = Graph(half, permute="degree")
    g1.init_vertexproperty(x=np.float32(0))
    if g1.perm is not None and g2.perm is not None \
            and not np.array_equal(g1.perm, g2.perm):
        with pytest.raises(ValueError, match="permutation"):
            g2.share_vertex_property(g1)
    g3 = Graph(half, permute=g1.perm if g1.perm is not None else False)
    g3.share_vertex_property(g1)
    g1.set_vertexproperty(2, x=5.0)
    assert g3.get_vertexproperty(2)["x"] == np.float32(5.0)


@pytest.mark.parametrize("mode", ["degree", True])
def test_vertex_permutation_transparent(mode):
    """Graph(permute=...) must be invisible through the public API."""
    from graphmat.apps.pagerank import run_pagerank
    e = random_edgelist(60, 4, seed=41)
    g0 = Graph(e)
    pr0, it0 = run_pagerank(g0)
    g1 = Graph(e, permute=mode)
    pr1, it1 = run_pagerank(g1)
    assert it0 == it1
    np.testing.assert_allclose(pr1, pr0, rtol=1e-5, atol=1e-6)
    assert g1.get_edges().as_records() == e.as_records()
    g1.init_vertexproperty(x=np.arange(60, dtype=np.int32))
    assert g1.get_vertexproperty(17)["x"] == 16


def test_vertex_permutation_bfs_source():
    from graphmat.apps.bfs import run_bfs
    e = random_edgelist(50, 3, seed=43)
    d0, p0, _ = run_bfs(Graph(e, build_in_edges=False), 5)
    d1, p1, _ = run_bfs(Graph(e, build_in_edges=False, permute="degree"), 5)
    np.testing.assert_array_equal(d1, d0)
