"""One engine step against a dense numpy generalized-SpMV reference.

Every ⊕ (sum, min, max, or, any, a generic associative combine) on
graphs with an empty edge set, a single edge, a hub sender, a hot
receiver, awkward vertex counts, uniform and RMAT structure; dense,
sparse and empty frontiers; ⊗ with and without edge values.  The
``hit`` plane and the next frontier check the ``got`` bitvector.
"""

import numpy as np
import pytest

from graphmat import Graph
from graphmat.core.runtime import Engine
from spmv_cases import (SemProgram, cases, init_vp, make_frontier,
                        make_graph, reference_step)


@pytest.mark.parametrize("kind,graph,frontier,use_ev", cases())
def test_engine_step_matches_dense_reference(kind, graph, frontier,
                                             use_ev):
    e = make_graph(graph)
    n = e.m
    g = Graph(e, build_in_edges=False)
    x = init_vp(g, n)
    front = make_frontier(frontier, n)
    g.set_active_mask(front)
    Engine(SemProgram(kind, use_ev), g).run(iterations=1)
    want_y, want_hit = reference_step(e, x, front, kind, use_ev)
    vp = g.vp_numpy()
    np.testing.assert_array_equal(vp["hit"], want_hit)
    np.testing.assert_array_equal(vp["y"], want_y)
    np.testing.assert_array_equal(np.asarray(g.active)[:n], want_hit)
    assert not np.asarray(g.active)[n:].any()
