"""applyToAllVertices / applyReduceAllVertices / applyToAllEdges tests —
mirrors ``test/test_apply_edges.cpp`` (val == src + s*dst invariant)."""

import jax.numpy as jnp
import numpy as np

from graphmat import Graph
from graphmat.core.graph_ops import (apply_reduce_all_vertices,
                                     apply_to_all_edges,
                                     apply_to_all_vertices)
from graphmat.utils.generators import random_edgelist


def make_graph(n=40, deg=4, seed=5):
    e = random_edgelist(n, deg, seed=seed)
    g = Graph(e)
    g.init_vertexproperty(val=np.arange(1, n + 1, dtype=np.int32))
    return g, e


def test_apply_to_all_vertices():
    g, e = make_graph()
    apply_to_all_vertices(g, lambda vp: {"val": vp["val"] * 2})
    np.testing.assert_array_equal(g.vp_numpy()["val"],
                                  2 * np.arange(1, 41))


def test_apply_reduce_sum_min_max():
    g, e = make_graph()
    out = apply_reduce_all_vertices(g, lambda vp: {"v": vp["val"]}, "sum")
    assert int(out["v"]) == sum(range(1, 41))
    out = apply_reduce_all_vertices(g, lambda vp: {"v": vp["val"]}, "min")
    assert int(out["v"]) == 1
    out = apply_reduce_all_vertices(g, lambda vp: {"v": vp["val"]}, "max")
    assert int(out["v"]) == 40


def test_apply_reduce_generic_combine():
    """Arbitrary user reduce fns (MapReduce parity,
    multinode/reduce.h:39-74): bare callable, generic Monoid, and a pytree
    mixing fast-path kinds with a callable."""
    from graphmat.core.types import Monoid
    g, e = make_graph()
    # product of values 1..40 mod nothing — use float64-safe logsum instead
    out = apply_reduce_all_vertices(
        g, lambda vp: {"v": vp["val"].astype(jnp.float32)},
        lambda a, b: jnp.maximum(a, b) + jnp.minimum(a, b) * 0)
    assert float(out["v"]) == 40.0
    # generic Monoid with identity (empty-safe)
    gcd = Monoid("generic", combine_fn=lambda a, b: jnp.gcd(a, b),
                 identity_fn=lambda dt: 0)
    g.init_vertexproperty(val=np.arange(2, 82, 2, dtype=np.int32))
    out = apply_reduce_all_vertices(g, lambda vp: {"v": vp["val"]}, gcd)
    assert int(out["v"]) == 2
    # pytree of reduces matching the mapped structure
    out = apply_reduce_all_vertices(
        g, lambda vp: {"a": vp["val"], "b": vp["val"]},
        {"a": "sum", "b": lambda x, y: jnp.minimum(x, y)})
    assert int(out["a"]) == sum(range(2, 82, 2)) and int(out["b"]) == 2


def test_apply_reduce_generic_dist():
    """Dist MapReduce accepts the same generic reduce specs."""
    import jax
    from graphmat.parallel.dist_graph import DistGraph
    from graphmat.parallel.dist_graph_ops import (
                                                  apply_reduce_all_vertices as dist_reduce)
    from graphmat.parallel.mesh import make_mesh
    e = random_edgelist(40, 4, seed=5)
    mesh = make_mesh(jax.devices()[:8], (2, 4))
    g = DistGraph(e, mesh, seg_align=8)
    g.init_vertexproperty(val=np.arange(1, 41, dtype=np.int32))
    out = dist_reduce(g, lambda vp: {"v": vp["val"]},
                      lambda a, b: jnp.maximum(a, b))
    assert int(out["v"]) == 40
    out = dist_reduce(g, lambda vp: {"v": vp["val"]}, "sum")
    assert int(out["v"]) == sum(range(1, 41))


def test_apply_to_all_edges_src_plus_s_dst():
    """The reference's check: after apply, every edge value equals
    src_prop + 5 * dst_prop (``test/test_apply_edges.cpp:38-113``)."""
    g, e = make_graph()
    apply_to_all_edges(
        g, lambda vs, vd, val: vs["val"] + 5 * vd["val"])
    out = g.get_edges()
    for s, d, v in out.as_records():
        assert v == s + 5 * d  # vertex property == 1-based id

    # in_edges ordering stays consistent
    g2 = Graph(e)  # rebuild to compare via in-edge export
    r = Graph.__new__(Graph)  # not needed; use graph's in_edges directly
    ea = g.in_edges
    valid = np.asarray(ea.valid)
    srcs = np.asarray(ea.receivers)[valid] + 1
    dsts = np.asarray(ea.senders)[valid] + 1
    vals = np.asarray(ea.vals)[valid]
    for s, d, v in zip(srcs, dsts, vals):
        assert v == s + 5 * d
