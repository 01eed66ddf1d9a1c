"""Engine-level variable-length (vector) messages — the port of the
reference's GetNeighbors end-to-end test (``test/test_get_neighbors.cpp:
131-137``), which exercises the SERIALIZED wire format: list-valued
messages reduced by concat.  Here the facility is
``GraphProgram.vector_message`` (static-width padded rows)."""

import jax.numpy as jnp
import numpy as np

from graphmat import Graph
from graphmat.apps.get_neighbors import (GetNeighborsProgram, PAD_ID,
                                         run_get_neighbors)
from graphmat.io.edgelist import edgelist_from_arrays
from graphmat.utils.generators import random_edgelist


def dense_edgelist(n):
    """Complete graph incl. self loops (the reference's
    generate_dense_edgelist used by the GetNeighbors test)."""
    src, dst = np.meshgrid(np.arange(1, n + 1), np.arange(1, n + 1),
                           indexing="ij")
    return edgelist_from_arrays(src.ravel(), dst.ravel(),
                                np.ones(n * n, np.int32))


def oracle_out_neighbors(e, n, width):
    out = np.full((n, width), PAD_ID, np.int64)
    for v in range(1, n + 1):
        ns = np.sort(e.dst[e.src == v])
        out[v - 1, : len(ns)] = ns
    return out


def test_get_neighbors_dense():
    """Reference assertion: on a dense graph every vertex collects
    exactly [1..n] (test_get_neighbors.cpp:119-137)."""
    n = 60
    g = Graph(dense_edgelist(n))
    nb = run_get_neighbors(g)
    ref = np.arange(1, n + 1)
    for v in range(n):
        np.testing.assert_array_equal(nb[v], ref)


def test_get_neighbors_random_matches_oracle():
    e = random_edgelist(200, 5, seed=3)
    g = Graph(e)
    nb = run_get_neighbors(g)
    ref = oracle_out_neighbors(e, 200, nb.shape[1])
    np.testing.assert_array_equal(nb, ref)


def test_get_neighbors_permuted_graph():
    e = random_edgelist(150, 4, seed=7)
    g = Graph(e, permute="degree")
    nb = run_get_neighbors(g)
    ref = oracle_out_neighbors(e, 150, nb.shape[1])
    np.testing.assert_array_equal(nb, ref)


def test_get_neighbors_dist_matches_single():
    import jax
    from graphmat.parallel.dist_graph import DistGraph
    from graphmat.parallel.mesh import make_mesh
    e = random_edgelist(96, 4, seed=9)
    g1 = Graph(e)
    nb1 = run_get_neighbors(g1)
    mesh = make_mesh(jax.devices()[:8], (2, 4))
    g2 = DistGraph(e, mesh, seg_align=8)
    nb2 = run_get_neighbors(g2)
    # widths differ (per-shard padding); compare the non-pad prefixes
    for v in range(96):
        a = nb1[v][nb1[v] != PAD_ID]
        b = nb2[v][nb2[v] != PAD_ID]
        np.testing.assert_array_equal(a, b)


def test_vector_message_active_only_frontier():
    """A user-writable vector-message program under ACTIVE_ONLY: only
    ACTIVE senders' contributions appear in the collected rows."""
    from graphmat.core.program import GraphProgram
    from graphmat.core.runtime import Engine
    from graphmat.core.types import Activity, Direction

    class CollectActive(GetNeighborsProgram):
        activity = Activity.ACTIVE_ONLY

    e = random_edgelist(120, 4, seed=11)
    g = Graph(e)
    prog = CollectActive()
    eng = Engine(prog, g)
    D = eng.vector_reduced_width
    g.init_vertexproperty(
        id=np.arange(1, 121, dtype=np.int32),
        neighbors=np.full((120, D), PAD_ID, np.int32))
    g.set_all_inactive()
    rng = np.random.default_rng(0)
    active = rng.random(120) < 0.4
    g.set_active_mask(active)
    eng.run(iterations=1)
    nb = g.vp_numpy()["neighbors"]
    # oracle: vertex v collects sorted ids of ACTIVE dst endpoints over
    # out-edges (IN_EDGES: sender = dst, receiver = src)
    for v in range(1, 121):
        ns = np.sort([d for s, d in zip(e.src, e.dst)
                      if s == v and active[d - 1]])
        got = nb[v - 1][nb[v - 1] != PAD_ID]
        if len(ns) == 0:
            assert len(got) == 0
        else:
            np.testing.assert_array_equal(got, ns)


def test_vector_message_all_edges_concat():
    """ALL_EDGES: both directions' contributions concat into one row."""
    from graphmat.core.runtime import Engine
    from graphmat.core.types import Direction

    class AllNeighbors(GetNeighborsProgram):
        order = Direction.ALL_EDGES

    e = random_edgelist(80, 3, seed=13)
    g = Graph(e)
    prog = AllNeighbors()
    eng = Engine(prog, g)
    D = eng.vector_reduced_width
    g.init_vertexproperty(id=np.arange(1, 81, dtype=np.int32),
                          neighbors=np.full((80, D), PAD_ID, np.int32))
    eng.run(iterations=1)
    nb = g.vp_numpy()["neighbors"]
    for v in range(1, 81):
        outn = e.dst[e.src == v]
        inn = e.src[e.dst == v]
        ref = np.sort(np.concatenate([outn, inn]))
        got = nb[v - 1][nb[v - 1] != PAD_ID]
        np.testing.assert_array_equal(got, ref)
