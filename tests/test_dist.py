"""Multi-device (2D-sharded) engine tests on a virtual 8-device CPU mesh —
the analog of the reference CI's ``mpirun -np 4`` runs (``.travis.yml:26``).

Every test checks the sharded engine against the single-device engine or a
scipy oracle on the same input.
"""

import jax
import numpy as np
import pytest

from graphmat import Graph
from graphmat.apps.bfs import BFSProgram
from graphmat.apps.pagerank import (DegreeProgram, PageRankProgram,
                                    run_pagerank)
from graphmat.apps.sssp import SSSPProgram, run_sssp
from graphmat.apps.sgd import SGDProgram, run_sgd
from graphmat.parallel.dist_graph import DistGraph
from graphmat.parallel.dist_runtime import DistEngine
from graphmat.parallel.mesh import factor2d, make_mesh
from graphmat.utils.generators import chain_edgelist, random_edgelist


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(jax.devices()[:8], (2, 4))


def test_factor2d():
    assert factor2d(8) == (2, 4)
    assert factor2d(16) == (4, 4)
    assert factor2d(7) == (1, 7)
    assert factor2d(12) == (3, 4)


def dist_pagerank(e, mesh, permute=False):
    g = DistGraph(e, mesh, permute=permute)
    g.init_vertexproperty(pagerank=np.float32(0.3), degree=np.int32(0))
    g.set_all_active()
    DistEngine(DegreeProgram(), g).run(iterations=1)
    niter = DistEngine(PageRankProgram(), g).run()
    return g.vp_numpy()["pagerank"], niter


@pytest.mark.parametrize("permute", [False, True])
def test_dist_pagerank_matches_single(mesh, permute):
    e = random_edgelist(100, 5, seed=17)
    g1 = Graph(e)
    pr1, it1 = run_pagerank(g1)
    pr2, it2 = dist_pagerank(e, mesh, permute=permute)
    assert it1 == it2
    np.testing.assert_allclose(pr2, pr1, rtol=1e-5, atol=1e-6)


def test_dist_pagerank_fixture(mesh):
    from graphmat import load_edgelist
    e = load_edgelist("data/test.bin.mtx")
    pr1, _ = run_pagerank(Graph(e))
    pr2, _ = dist_pagerank(e, mesh)
    np.testing.assert_allclose(pr2, pr1, rtol=1e-5, atol=1e-6)


def test_dist_bfs_matches_single(mesh):
    """ACTIVE_ONLY + overwrite(min) monoid through the all_to_all path."""
    e = random_edgelist(90, 3, seed=23)
    g1 = Graph(e, build_in_edges=False)
    from graphmat.apps.bfs import run_bfs
    d1, p1, it1 = run_bfs(g1, 1)

    g2 = DistGraph(e, mesh, build_in_edges=False)
    init_dist_bfs(g2, 1)
    it2 = DistEngine(BFSProgram(), g2).run()
    vp = g2.vp_numpy()
    assert it1 == it2
    np.testing.assert_array_equal(vp["depth"], d1)
    np.testing.assert_array_equal(vp["parent"], p1)


def init_dist_bfs(g: DistGraph, source1: int):
    ids = np.arange(1, g.n + 1, dtype=np.int32)
    from graphmat.apps.bfs import INF_DEPTH
    g.init_vertexproperty(depth=np.int32(INF_DEPTH), parent=np.int32(-1),
                          id=ids)
    g.set_all_inactive()
    g.set_vertexproperty(source1, depth=0)
    g.set_active(source1)


def test_dist_sssp_min_monoid(mesh):
    e = random_edgelist(80, 4, seed=29, weight_range=9)
    d1, _ = run_sssp(Graph(e, build_in_edges=False), 1)

    g = DistGraph(e, mesh, build_in_edges=False)
    from graphmat.apps.sssp import INF_DIST
    g.init_vertexproperty(distance=np.int32(INF_DIST))
    g.set_all_inactive()
    g.set_vertexproperty(1, distance=0)
    g.set_active(1)
    DistEngine(SSSPProgram(), g).run()
    np.testing.assert_array_equal(g.vp_numpy()["distance"], d1)


def test_dist_sgd_three_operand(mesh):
    """ALL_EDGES + receiver-vertexprop gather (row broadcast path)."""
    from graphmat import load_edgelist
    e = load_edgelist("data/ratings7.bin.mtx")
    lv1, r0_1, r1_1 = run_sgd(Graph(e), k=8, iterations=5)

    g = DistGraph(e, mesh)
    init_dist_sgd(g, k=8)
    DistEngine(SGDProgram(), g).run(iterations=5)
    lv2 = g.vp_numpy()["lv"]
    np.testing.assert_allclose(lv2, lv1, rtol=1e-5, atol=1e-6)


def init_dist_sgd(g: DistGraph, k: int):
    from graphmat.utils.reference_rng import rand_r_uniform_np
    seeds = np.arange(1, g.n + 1, dtype=np.uint32)
    lv = rand_r_uniform_np(seeds, k).astype(np.float32)
    g.init_vertexproperty(lv=lv, sqerr=np.float32(0))


def test_dist_lda_state_psum(mesh):
    """do_every_iteration's global reduce must psum across the mesh."""
    import jax.numpy as jnp
    from graphmat.apps.lda import LDAInitProgram, LDAProgram
    from test_ml_apps import bipartite_edges, lda_oracle
    ndoc, nterms, k = 5, 7, 4
    e = bipartite_edges(ndoc, nterms, seed=31)
    expect = lda_oracle(e, ndoc, nterms, k, iters=3)

    g = DistGraph(e, mesh)
    is_doc = np.zeros(g.n, bool)
    is_doc[:ndoc] = True
    g.init_vertexproperty(N=np.zeros((g.n, k), np.float32), is_doc=is_doc,
                          token_loglik=np.float32(0))
    DistEngine(LDAInitProgram(k), g).run(iterations=1)
    prog = LDAProgram(k, vocab_size=nterms)
    eng = DistEngine(prog, g)
    gn0 = jnp.sum(jnp.where(~np.asarray(g.vp["is_doc"])[:, None]
                            & np.asarray(g.valid_vertex)[:, None],
                            np.asarray(g.vp["N"]), 0), axis=0)
    eng.run(iterations=3, state=gn0)
    np.testing.assert_allclose(g.vp_numpy()["N"], expect, rtol=2e-4,
                               atol=2e-4)


def test_dist_chain_convergence_loop(mesh):
    """while_loop with collectives inside shard_map: BFS along a chain
    takes exactly n iterations."""
    n = 30
    e = chain_edgelist(n)
    g = DistGraph(e, mesh, build_in_edges=False)
    init_dist_bfs(g, 1)
    niter = DistEngine(BFSProgram(), g).run()
    assert niter == n
    np.testing.assert_array_equal(g.vp_numpy()["depth"], np.arange(n))


def test_multihost_helpers_single_process(tmp_path):
    """Single-process behavior of the multi-host scaffolding."""
    from graphmat.io.edgelist import write_edgelist
    from graphmat.parallel.multihost import (initialize,
                                             load_edgelist_sharded)
    initialize()  # no-op single process
    e = random_edgelist(40, 4, seed=3)
    prefix = str(tmp_path / "shard")
    write_edgelist(e, prefix, nshards=3)
    r = load_edgelist_sharded(prefix)
    assert r.nnz == e.nnz
    assert r.as_records() == e.as_records()


def test_dist_degree_permute(mesh):
    e = random_edgelist(80, 4, seed=51)
    pr_ref, it_ref = dist_pagerank(e, mesh)
    g = DistGraph(e, mesh, permute="degree")
    g.init_vertexproperty(pagerank=np.float32(0.3), degree=np.int32(0))
    g.set_all_active()
    DistEngine(DegreeProgram(), g).run(iterations=1)
    it2 = DistEngine(PageRankProgram(), g).run()
    np.testing.assert_allclose(g.vp_numpy()["pagerank"], pr_ref,
                               rtol=1e-5, atol=1e-6)
    assert it2 == it_ref


def test_dist_lda_permuted(mesh):
    """LDA on a degree-permuted DistGraph matches the oracle (is_doc is
    a vertex property, so the doc/term split survives the relabeling)."""
    import jax.numpy as jnp
    from graphmat.apps.lda import run_lda
    from test_ml_apps import bipartite_edges, lda_oracle
    ndoc, nterms, k = 6, 9, 4
    e = bipartite_edges(ndoc, nterms, seed=11)
    expect = lda_oracle(e, ndoc, nterms, k, iters=3)
    g = DistGraph(e, mesh, permute="degree")
    assert g.perm is not None
    N, gN, ll = run_lda(g, ndoc, nterms, k=k, iterations=3)
    np.testing.assert_allclose(N, expect, rtol=2e-4, atol=2e-4)


def test_dist_auto_permute_bounds_tile_skew(mesh):
    """Power-law default (segment-strided degree permute): tile edge
    counts stay within 2x the mean, so one hub tile no longer sets the
    padded memory of all R*C tiles."""
    from graphmat.utils.generators import rmat_edgelist
    e = rmat_edgelist(11, 8, seed=3)
    g = DistGraph(e, mesh)                     # permute="auto" default
    assert g.perm is not None, "skewed RMAT should trigger the permute"
    tiles = g._host_tiles["dst"]
    cnt = np.array([len(s) for (s, r, v) in tiles], float)
    assert cnt.max() <= 2.0 * cnt.mean(), (cnt.max(), cnt.mean())
    # un-permuted natural layout violates the bound (the hazard exists)
    g0 = DistGraph(e, mesh, permute=False)
    cnt0 = np.array([len(s) for (s, r, v) in g0._host_tiles["dst"]],
                    float)
    assert cnt0.max() > 2.0 * cnt0.mean()
    # results match the single-device engine through the permute
    from graphmat import Graph
    from graphmat.apps.pagerank import run_pagerank
    pr_d, it_d = run_pagerank(g)
    pr_s, it_s = run_pagerank(Graph(e))
    np.testing.assert_allclose(np.asarray(pr_d), np.asarray(pr_s),
                               rtol=2e-4, atol=2e-5)
