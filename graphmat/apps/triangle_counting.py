"""Triangle counting (reference: ``src/TriangleCounting.cpp``).

Intended input: an upper-triangular DAG (each undirected edge stored once,
low id → high id).  Two phases:

1. **GetNeighbors** (:80-111): every vertex learns its out-neighbor id list.
   The reference runs an IN_EDGES pass with variable-length
   Boost-serialized vector messages; the static-shape equivalent materializes
   a padded ``[n, max_degree]`` sorted neighbor matrix
   (``ops.neighbors.collect_neighbors`` — see that module for why).
2. **CountTriangles** (:114-156): OUT_EDGES — each edge (s→r) contributes
   ``|N(s) ∩ N(r)|`` to r's count; ⊕ = sum.  Runs through the standard
   engine with the neighbor matrix as a vertex property, the intersection
   vectorized as a batched binary search.

Total triangles = Σ per-vertex counts (each triangle {a<b<c} is counted
once: at edge a→b as |N(a)∩N(b)| ∋ c).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM
from ..ops.neighbors import collect_neighbors, intersect_sorted_counts

__all__ = ["CountTrianglesProgram", "run_triangle_counting"]


class CountTrianglesProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def send_message(self, state, vp):
        return vp["neighbors"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        return intersect_sorted_counts(msg, vp_r["neighbors"])

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["triangles"] = vp["triangles"] + reduced
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["triangles"] != new_vp["triangles"]


def run_triangle_counting(graph: Graph, max_degree_pad: int | None = None,
                          method: str = "auto"):
    """Returns ``(triangles[n], total)``.

    ``method='engine'`` runs the reference-shaped GraphProgram (per-vertex
    counts attribute each triangle to its id-middle vertex, exactly as
    ``src/TriangleCounting.cpp``); it materializes a ``[n, max_degree]``
    neighbor matrix.  ``method='bucketed'`` runs the scalable
    degree-oriented core-bitmap path (``ops.triangles``, fully on-device
    prep) — identical total, per-vertex counts at the degree-minimum
    vertex, memory bounded by O(m + n*h/8 bitmap).
    ``'auto'`` picks engine for small max degree, bucketed otherwise.
    """
    if method == "auto":
        from ..ops.neighbors import max_degree
        method = ("engine" if max_degree(graph, "src") <= 1024
                  else "bucketed")
    if method == "bucketed":
        from ..ops.triangles import count_triangles_bucketed
        s0, r0, _ = graph._host_edges["dst"]
        tri, total = count_triangles_bucketed(s0, r0, graph.n,
                                              n_pad=graph.n_pad)
        graph.init_vertexproperty(triangles=np.int32(0))
        graph.vp = {**graph.vp, "triangles": jnp.asarray(tri)}
        return np.asarray(tri)[: graph.n_pad], total

    neighbors = collect_neighbors(graph, receiver="src",
                                  pad_to=max_degree_pad)
    graph.init_vertexproperty(triangles=np.int32(0))
    graph.vp = {**graph.vp, "neighbors": neighbors}

    engine_for(CountTrianglesProgram(), graph).run(iterations=1)
    tri = graph.vp_numpy()["triangles"]
    return tri, int(tri.sum())


def _main(argv=None):
    """CLI parity with ``src/TriangleCounting.cpp``: <A.mtx> (upper-tri)."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = (argv if argv is not None else sys.argv[1:])
    if not args:
        print("Correct format: triangle_counting A.mtx")
        return 0
    from ..core.graph import Graph
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    tri, total = run_triangle_counting(g)
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Total triangles = {total}")
    for i in range(min(10, g.n)):
        print(f"{i + 1} : {tri[i]}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
