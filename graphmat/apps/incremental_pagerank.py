"""Incremental (delta) PageRank (reference: ``src/IncrementalPageRank.cpp``).

Delta-propagation PageRank: vertices carry ``(delta, pagerank, degree)``
with ctor defaults (0.3, 0.3, 0) (:38-43).  After a degree pass, the
ACTIVE_ONLY delta program runs until no vertex's pagerank moves by more
than 1e-8 — only vertices whose rank changed stay active, so work shrinks
as ranks settle.

apply (:112-117): reset delta if it was significant, accumulate
``(1-alpha)·Σ msg``, and fold into pagerank when significant;
``operator!=`` is ``|Δpagerank| > 1e-8`` (:44-46).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM, UNTIL_CONVERGENCE
from .pagerank import DegreeProgram

__all__ = ["DeltaPageRankProgram", "run_incremental_pagerank"]


class DeltaPageRankProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = SUM
    process_requires_vertexprop = False

    def __init__(self, alpha: float = 0.3, tol: float = 1e-8,
                 dtype=jnp.float32):
        self.alpha = alpha
        self.tol = tol
        self.dtype = dtype

    def send_message(self, state, vp):
        deg = vp["degree"].astype(self.dtype)
        msg = jnp.where(deg == 0, jnp.array(0, self.dtype),
                        vp["delta"] / jnp.maximum(deg, 1))
        return msg, None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        delta = jnp.where(jnp.abs(vp["delta"]) > self.tol,
                          jnp.array(0, self.dtype), vp["delta"])
        delta = delta + jnp.array(1.0 - self.alpha, self.dtype) * reduced
        significant = jnp.abs(delta) > self.tol
        out = dict(vp)
        out["delta"] = delta
        out["pagerank"] = jnp.where(significant, vp["pagerank"] + delta,
                                    vp["pagerank"])
        return out

    def changed(self, old_vp, new_vp):
        return jnp.abs(old_vp["pagerank"] - new_vp["pagerank"]) > self.tol


def run_incremental_pagerank(graph: Graph, alpha: float = 0.3,
                             iterations: int = UNTIL_CONVERGENCE,
                             dtype=jnp.float32,
                             max_iterations: int = 10_000):
    """Full reference flow (:128-160); returns ``(pagerank[n], niter)``."""
    graph.init_vertexproperty(
        delta=np.array(0.3, np.dtype(dtype)),
        pagerank=np.array(0.3, np.dtype(dtype)),
        degree=np.int32(0),
    )
    graph.set_all_active()
    engine_for(DegreeProgram(), graph).run(iterations=1)

    graph.set_all_active()
    prog = DeltaPageRankProgram(alpha=alpha, dtype=dtype)
    niter = engine_for(prog, graph).run(iterations=iterations,
                                    max_iterations=max_iterations)
    return graph.vp_numpy()["pagerank"], niter


def _main(argv=None):
    """CLI parity with ``src/IncrementalPageRank.cpp``: <A.mtx>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = (argv if argv is not None else sys.argv[1:])
    if not args:
        print("Correct format: incremental_pagerank A.mtx")
        return 0
    from ..core.graph import Graph
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    pr, niter = run_incremental_pagerank(g)
    print(f"PR Time = {(time.time() - t0) * 1e3:.3f} ms "
          f"({niter} iterations)")
    deg = g.vp_numpy()["degree"]
    for i in range(min(25, g.n)):
        print(f"{i + 1} : {deg[i]} {pr[i]:.6f}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
