"""Delta-stepping SSSP (reference: ``src/DeltaStepping.cpp``).

The edge list is split by weight into a light graph (w ≤ delta) and a heavy
graph (w > delta) via ``filter_edges`` (``src/DeltaStepping.cpp:119-137``);
the two graphs share one vertex-property vector
(``G2.shareVertexProperty(G)``, :142).  The outer host loop per bucket
(:160-178):

1. light graph until convergence,
2. heavy graph for 1 iteration,
3. ``bid += 1``; continue while any vertex sits in a bucket ≥ bid.

Program semantics (:78-98): message = distance if the vertex is in the
current bucket else INF; ⊗ = saturating msg+w; ⊕ = min; apply relaxes and
re-buckets ``bucket = distance // delta``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import Engine
from ..core.types import Activity, Direction, MIN, UNTIL_CONVERGENCE
from ..io.edgelist import EdgeList
from ..io.transforms import filter_edges

__all__ = ["DeltaSteppingProgram", "run_delta_stepping",
           "run_delta_stepping_dist", "INF_DIST", "INF_BUCKET"]


INF_DIST = np.iinfo(np.int32).max
INF_BUCKET = np.iinfo(np.int32).max


class DeltaSteppingProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = MIN
    process_requires_vertexprop = False

    def __init__(self, delta: int):
        self.delta = int(delta)

    def init_state(self, graph):
        return jnp.int32(0)  # bid

    def send_message(self, state, vp):
        bid = state
        msg = jnp.where(vp["bucket"] == bid, vp["distance"],
                        jnp.int32(INF_DIST))
        return msg, None

    def process_message(self, state, msg, edge_vals, vp_r):
        ev = edge_vals.astype(jnp.int32)
        return jnp.where(msg >= INF_DIST - ev, INF_DIST, msg + ev)

    def apply(self, state, reduced, vp):
        better = vp["distance"] > reduced
        out = dict(vp)
        out["distance"] = jnp.where(better, reduced, vp["distance"])
        out["bucket"] = jnp.where(better, reduced // self.delta, vp["bucket"])
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["distance"] != new_vp["distance"]


def run_delta_stepping(edges: EdgeList, delta: int, source1: int,
                       max_buckets: int = 1_000_000):
    """Full reference flow; returns ``(distance[n], nbuckets)``."""
    light = filter_edges(edges, lambda s, d, v: v <= delta)
    heavy = filter_edges(edges, lambda s, d, v: v > delta)

    g = Graph(light, build_in_edges=False)
    g2 = Graph(heavy, build_in_edges=False)
    g.init_vertexproperty(distance=np.int32(INF_DIST),
                          bucket=np.int32(INF_BUCKET))
    g2.share_vertex_property(g)

    g.set_vertexproperty(source1, distance=0, bucket=0)
    g.set_active(source1)

    prog = DeltaSteppingProgram(delta)
    eng_light = Engine(prog, g)
    eng_heavy = Engine(prog, g2)

    bid = 0
    while True:
        g.set_all_active()
        eng_light.run(iterations=UNTIL_CONVERGENCE, state=jnp.int32(bid))
        g2.set_all_active()
        eng_heavy.run(iterations=1, state=jnp.int32(bid))
        bid += 1
        bucket = g.vp_numpy()["bucket"]
        if not ((bucket >= bid) & (bucket < INF_BUCKET)).any():
            break
        if bid >= max_buckets:
            raise RuntimeError("delta-stepping did not terminate")
    return g.vp_numpy()["distance"], bid


def run_delta_stepping_dist(edges: EdgeList, delta: int, source1: int,
                            mesh, max_buckets: int = 1_000_000,
                            seg_align: int = 128):
    """2D-sharded delta-stepping: two DistGraphs (light/heavy) over one
    mesh sharing the vertex-property store, same outer bucket loop."""
    from ..parallel.dist_graph import DistGraph
    from ..parallel.dist_runtime import DistEngine

    light = filter_edges(edges, lambda s, d, v: v <= delta)
    heavy = filter_edges(edges, lambda s, d, v: v > delta)

    g = DistGraph(light, mesh, build_in_edges=False, seg_align=seg_align)
    # the heavy graph MUST share g's vertex permutation (auto-permute
    # would derive a different one from its own degree distribution and
    # silently misalign the shared vertex properties)
    g2 = DistGraph(heavy, mesh, build_in_edges=False, seg_align=seg_align,
                   permute=g.perm if g.perm is not None else False)
    g.init_vertexproperty(distance=np.int32(INF_DIST),
                          bucket=np.int32(INF_BUCKET))
    g2.share_vertex_property(g)

    g.set_vertexproperty(source1, distance=0, bucket=0)
    g.set_active(source1)

    prog = DeltaSteppingProgram(delta)
    eng_light = DistEngine(prog, g)
    eng_heavy = DistEngine(prog, g2)

    bid = 0
    while True:
        g.set_all_active()
        eng_light.run(iterations=UNTIL_CONVERGENCE, state=jnp.int32(bid))
        g2.set_all_active()
        eng_heavy.run(iterations=1, state=jnp.int32(bid))
        bid += 1
        bucket = g.vp_numpy()["bucket"]
        if not ((bucket >= bid) & (bucket < INF_BUCKET)).any():
            break
        if bid >= max_buckets:
            raise RuntimeError("delta-stepping did not terminate")
    return g.vp_numpy()["distance"], bid


def _main(argv=None):
    """CLI parity with ``src/DeltaStepping.cpp``: <A.mtx> <delta> <source>."""
    import sys
    import time
    from ._cli import load_graph_file
    args = (argv if argv is not None else sys.argv[1:])
    if len(args) < 3:
        print("Correct format: delta_stepping A.mtx delta source")
        return 0
    e = load_graph_file(args[0])
    t0 = time.time()
    dist, nbuckets = run_delta_stepping(e, int(args[1]), int(args[2]))
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Number of buckets processed = {nbuckets}")
    print(f"Reachable vertices = {int((dist < INF_DIST).sum())}")
    for i in range(min(25, len(dist))):
        d = "INF" if dist[i] >= INF_DIST else str(dist[i])
        print(f"{i + 1} : distance = {d}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
