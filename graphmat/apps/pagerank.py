"""PageRank (reference: ``src/PageRank.cpp``).

Two passes, exactly mirroring the reference:

1. **Degree** (``src/PageRank.cpp:55-79``): IN_EDGES, one iteration — every
   vertex sends 1 against edge direction, so each vertex receives one message
   per out-edge; ⊕ = sum gives the out-degree.
2. **PageRank** (``src/PageRank.cpp:82-112``): OUT_EDGES, ALL_VERTICES, until
   convergence — message = pr/degree, ⊕ = sum,
   apply: ``pr = alpha + (1-alpha)·Σ``; a vertex "changes" (stays
   unconverged) when ``|Δpr| > 1e-5`` (``src/PageRank.cpp:43-45``).

Initial pagerank is 0.3 (the PR() default ctor).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM, UNTIL_CONVERGENCE

__all__ = ["DegreeProgram", "PageRankProgram", "run_pagerank"]


class DegreeProgram(GraphProgram):
    """Out-degree via IN_EDGES sum of unit messages."""

    order = Direction.IN_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = SUM
    process_requires_vertexprop = False

    def __init__(self, field: str = "degree"):
        self.field = field

    def send_message(self, state, vp):
        some = next(iter(vp.values()))
        return jnp.ones(some.shape[0], jnp.int32), None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out[self.field] = reduced
        return out


class PageRankProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = False

    def __init__(self, alpha: float = 0.3, tol: float = 1e-5,
                 dtype=jnp.float32):
        self.alpha = alpha
        self.tol = tol
        self.dtype = dtype

    def send_message(self, state, vp):
        deg = vp["degree"].astype(self.dtype)
        msg = jnp.where(deg == 0, jnp.array(0, self.dtype),
                        vp["pagerank"] / jnp.maximum(deg, 1))
        return msg, None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["pagerank"] = (jnp.array(self.alpha, self.dtype)
                           + jnp.array(1.0 - self.alpha, self.dtype) * reduced)
        return out

    def changed(self, old_vp, new_vp):
        return jnp.abs(old_vp["pagerank"] - new_vp["pagerank"]) > self.tol


def init_pagerank_graph(graph: Graph, dtype=jnp.float32) -> None:
    """PR() default ctor state: pagerank=0.3, degree=0 (``src/PageRank.cpp:39-42``)."""
    graph.init_vertexproperty(
        pagerank=np.array(0.3, np.dtype(dtype)),
        degree=np.array(0, np.int32),
    )


def run_pagerank(graph: Graph, alpha: float = 0.3,
                 iterations: int = UNTIL_CONVERGENCE, dtype=jnp.float32):
    """Full reference flow: degree pass then PR to convergence.

    Returns ``(pagerank[n], niter)``.
    """
    init_pagerank_graph(graph, dtype)

    dg = DegreeProgram()
    graph.set_all_active()
    engine_for(dg, graph).run(iterations=1)

    pr = PageRankProgram(alpha=alpha, dtype=dtype)
    eng = engine_for(pr, graph)
    niter = eng.run(iterations=iterations)
    return graph.vp_numpy()["pagerank"], niter


def _main(argv=None):
    """CLI parity with ``src/PageRank.cpp`` usage: <A.mtx>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = (argv if argv is not None else sys.argv[1:])
    if not args:
        print("Correct format: pagerank A.mtx")
        return 0
    from ..core.graph import Graph
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    pr, niter = run_pagerank(g)
    print(f"Completed {niter} iterations")
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    for i in range(min(25, g.n)):
        print(f"{i + 1} : {pr[i]:.6f}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
