"""Topological sort, Kahn's algorithm (reference: ``src/TopologicalSort.cpp``).

Pass 1 — InDegree (:60-85): OUT_EDGES, ALL_VERTICES, 1 iteration; every
vertex sends 1 along its out-edges, receivers sum → in-degree.

Pass 2 — TopSort (:89-127): ACTIVE_ONLY, OUT_EDGES.  Vertices with
``in_degree == 0`` (and order 0 seeds, set on host like :156-167) send
``True``; others active still send ``False`` which processes to 0.  apply
decrements in-degree by the count received and assigns
``topsort_order = current_order`` when it hits zero.  A vertex's
``operator!=`` compares topsort_order only (:48-50), so exactly the
newly-ordered vertices become active.

A cycle leaves vertices at INF order (:177-184).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM, UNTIL_CONVERGENCE

__all__ = ["TopSortProgram", "run_topological_sort", "INF_ORDER"]

INF_ORDER = np.iinfo(np.int32).max


class InDegreeProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = False

    def send_message(self, state, vp):
        some = next(iter(vp.values()))
        return jnp.ones(some.shape[0], jnp.int32), None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["in_degree"] = reduced
        return out


class TopSortProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = SUM
    process_requires_vertexprop = False

    def init_state(self, graph):
        return jnp.int32(1)  # current_topsort_order (:97)

    def send_message(self, state, vp):
        return (vp["in_degree"] == 0).astype(jnp.int32), None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        current = state
        new_indeg = vp["in_degree"] - reduced
        done = (new_indeg == 0) & (vp["in_degree"] > 0)
        out = dict(vp)
        out["in_degree"] = new_indeg
        out["topsort_order"] = jnp.where(done, current, vp["topsort_order"])
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["topsort_order"] != new_vp["topsort_order"]

    def do_every_iteration(self, state, vp, it, ctx):
        return state + 1


def run_topological_sort(graph: Graph,
                         iterations: int = UNTIL_CONVERGENCE):
    """Returns ``(order[n], has_cycle, niter)``.

    ``order`` is 0 for sources, increasing along edges; INF_ORDER marks
    vertices on/behind a cycle.
    """
    graph.init_vertexproperty(topsort_order=np.int32(INF_ORDER),
                              in_degree=np.int32(0))
    engine_for(InDegreeProgram(), graph).run(iterations=1)

    indeg = graph.vp_numpy()["in_degree"]
    seeds = np.where(indeg == 0)[0]
    order0 = graph.vp["topsort_order"]
    order0 = order0.at[seeds].set(0)
    graph.vp = {**graph.vp, "topsort_order": order0}
    graph.set_all_inactive()
    active = graph.active
    graph.active = active.at[seeds].set(True)

    niter = engine_for(TopSortProgram(), graph).run(iterations=iterations)
    order = graph.vp_numpy()["topsort_order"]
    has_cycle = bool((order == INF_ORDER).any())
    return order, has_cycle, niter


def _main(argv=None):
    """CLI parity with ``src/TopologicalSort.cpp``: <A.mtx>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = (argv if argv is not None else sys.argv[1:])
    if not args:
        print("Correct format: topological_sort A.mtx")
        return 0
    from ..core.graph import Graph
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    order, has_cycle, niter = run_topological_sort(g)
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    if has_cycle:
        print("Topological Sort not possible. Graph has cycles.")
        return 0
    for i in range(min(10, g.n)):
        print(f"Top Sort order {i + 1} : {order[i]}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
