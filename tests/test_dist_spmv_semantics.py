"""The one-step semantics cases on ``DistEngine`` over the 8 virtual CPU
devices (a 2x4 mesh): tile bucketing, the column-axis ⊕ fold (psum_scatter
for sum, all_to_all + local ⊕ otherwise) and the sharded ``got`` plane
must give the dense numpy reference's answer."""

import jax
import numpy as np
import pytest

from graphmat.parallel.dist_graph import DistGraph
from graphmat.parallel.dist_runtime import DistEngine
from graphmat.parallel.mesh import make_mesh
from spmv_cases import (GRAPHS, KINDS, SemProgram, init_vp, make_frontier,
                        make_graph, reference_step)

CASES = ([(k, "rmat8", "sparse", True) for k in KINDS]
         + [(k, "hot_receiver", "dense", True) for k in KINDS]
         + [("sum", g, "sparse", True) for g in GRAPHS if g != "rmat8"]
         + [("min", "uniform", "empty", True),
            ("generic", "n129", "dense", False)])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:8], (2, 4))


@pytest.mark.parametrize("kind,graph,frontier,use_ev", CASES)
def test_dist_step_matches_dense_reference(mesh, kind, graph, frontier,
                                           use_ev):
    e = make_graph(graph)
    n = e.m
    g = DistGraph(e, mesh, build_in_edges=False)
    x = init_vp(g, n)
    front = make_frontier(frontier, n)
    g.set_active_mask(front)
    DistEngine(SemProgram(kind, use_ev), g).run(iterations=1)
    want_y, want_hit = reference_step(e, x, front, kind, use_ev)
    vp = g.vp_numpy()
    np.testing.assert_array_equal(vp["hit"], want_hit)
    np.testing.assert_array_equal(vp["y"], want_y)
