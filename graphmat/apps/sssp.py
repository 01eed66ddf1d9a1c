"""Single-source shortest paths, Bellman-Ford style (reference: ``src/SSSP.cpp``).

OUT_EDGES; ⊕ = min, ⊗ = message + edge weight (``src/SSSP.cpp:73-79``);
apply: ``distance = min(distance, reduced)``.  Distances use int32 with an
INF sentinel (the reference's unsigned int MAX_DIST); message addition
saturates at INF to avoid wraparound.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, MIN, UNTIL_CONVERGENCE

__all__ = ["SSSPProgram", "run_sssp", "INF_DIST"]

INF_DIST = np.iinfo(np.int32).max


class SSSPProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = MIN
    process_requires_vertexprop = False

    def send_message(self, state, vp):
        return vp["distance"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        # saturating add: INF + w stays INF (reference relies on unsigned
        # wrap being filtered by the min-apply; saturate instead)
        ev = edge_vals.astype(jnp.int32)
        return jnp.where(msg >= INF_DIST - ev, INF_DIST, msg + ev)

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["distance"] = jnp.minimum(vp["distance"], reduced)
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["distance"] != new_vp["distance"]


def init_sssp_graph(graph: Graph, source1: int) -> None:
    graph.init_vertexproperty(distance=np.int32(INF_DIST))
    graph.set_all_inactive()
    graph.set_vertexproperty(source1, distance=0)
    graph.set_active(source1)


def run_sssp(graph: Graph, source1: int,
             iterations: int = UNTIL_CONVERGENCE):
    """Returns ``(distance[n], niter)``; unreachable = INF_DIST."""
    init_sssp_graph(graph, source1)
    eng = engine_for(SSSPProgram(), graph)
    niter = eng.run(iterations=iterations)
    return graph.vp_numpy()["distance"], niter


def reachable_count(graph: Graph) -> int:
    return int((graph.vp_numpy()["distance"] < INF_DIST).sum())


def _main(argv=None):
    """CLI parity with ``src/SSSP.cpp``: <A.mtx> <source 1-based>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = (argv if argv is not None else sys.argv[1:])
    if len(args) < 2:
        print("Correct format: sssp A.mtx source_vertex (1-based index)")
        return 0
    from ..core.graph import Graph
    g = build_graph(load_graph_file(args[0]), build_in_edges=False)
    t0 = time.time()
    dist, niter = run_sssp(g, int(args[1]))
    print(f"Completed {niter} iterations")
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Reachable vertices = {int((dist < INF_DIST).sum())}")
    for i in range(min(25, g.n)):
        d = "INF" if dist[i] >= INF_DIST else str(dist[i])
        print(f"{i + 1} : distance = {d}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
