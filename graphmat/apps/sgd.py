"""SGD matrix completion / collaborative filtering (reference: ``src/SGD.cpp``).

The rating matrix is a square graph whose vertices carry K-dim latent
factors; ALL_EDGES + ALL_VERTICES means every edge contributes gradient
pushes in both directions each iteration (:84-89).  This is the 3-operand
(SpMSpV3) path: ``process_message`` reads the *receiver's* factors to form
the prediction error (:95-106) — one extra gather feeding an ``[e, K]``
elementwise block, and the factor matrices behave like sharded
embedding tables with gather + segment-sum gradient pushes.

Semantics:
* message = sender's latent vector,
* ⊗: ``err = rating − ⟨msg, vp_recv⟩``;  contribution = ``msg · err``,
* ⊕ = sum,
* apply: ``lv += step · (−lambda·lv + Σ)`` (:113-117).

Init matches the reference bit-for-bit: vertex i's factors are
``rand_r(seed=i)/RAND_MAX`` draws (:176-184, glibc LCG — see
``utils.reference_rng``).  Defaults λ=0.001, step=3.5e-7, 10 iterations
(:170,200).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM
from ..utils.reference_rng import rand_r_uniform_np

__all__ = ["SGDProgram", "RMSEProgram", "run_sgd", "init_sgd_graph",
           "rmse_per_edge"]


class SGDProgram(GraphProgram):
    order = Direction.ALL_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def __init__(self, lambda_: float = 0.001, step: float = 3.5e-7,
                 dtype=jnp.float32, k: int = 20):
        self.lambda_ = lambda_
        self.step = step
        self.dtype = dtype
        self.k = k

    def send_message(self, state, vp):
        return vp["lv"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        est = jnp.sum(msg * vp_r["lv"], axis=1)
        err = edge_vals.astype(self.dtype) - est
        return msg * err[:, None]

    def apply(self, state, reduced, vp):
        lv = vp["lv"]
        out = dict(vp)
        out["lv"] = lv + jnp.array(self.step, self.dtype) * (
            -jnp.array(self.lambda_, self.dtype) * lv + reduced)
        return out

    def changed(self, old_vp, new_vp):
        return jnp.any(jnp.abs(old_vp["lv"] - new_vp["lv"]) > 1e-7, axis=1)


class RMSEProgram(GraphProgram):
    """Per-vertex squared error over IN_EDGES (:122-156).

    ALL_VERTICES like the reference flow (``setAllActive`` + 1
    iteration, ``src/SGD.cpp:199-208``)."""

    order = Direction.IN_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def __init__(self, dtype=jnp.float32, k: int = 20):
        self.dtype = dtype
        self.k = k

    def send_message(self, state, vp):
        return vp["lv"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        est = jnp.sum(msg * vp_r["lv"], axis=1)
        err = edge_vals.astype(self.dtype) - est
        return err * err

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["sqerr"] = reduced
        return out


def init_sgd_graph(graph: Graph, k: int = 20, dtype=jnp.float32) -> None:
    """Reference init: vertex i (1-based) draws k uniforms via rand_r(i)."""
    seeds = np.arange(1, graph.n + 1, dtype=np.uint32)
    lv = rand_r_uniform_np(seeds, k).astype(np.dtype(dtype))
    graph.init_vertexproperty(lv=lv,
                              sqerr=np.array(0, np.dtype(dtype)))


def rmse_per_edge(graph: Graph, dtype=jnp.float32, k: int = 20) -> float:
    """sqrt(Σ sqerr / nnz) — the reference's printed metric (:186-188)."""
    graph.set_all_active()
    engine_for(RMSEProgram(dtype=dtype, k=k), graph).run(iterations=1)
    err = float(graph.vp_numpy()["sqerr"].sum())
    return float(np.sqrt(err / graph.nnz))


def run_sgd(graph: Graph, k: int = 20, lambda_: float = 0.001,
            step: float = 3.5e-7, iterations: int = 10, dtype=jnp.float32):
    """Full reference flow (:160-220): init, RMSE, 10 SGD iters, RMSE.

    Returns ``(lv[n,k], rmse_before, rmse_after)``.
    """
    init_sgd_graph(graph, k, dtype)
    rmse0 = rmse_per_edge(graph, dtype, k)

    graph.set_all_active()
    engine_for(SGDProgram(lambda_, step, dtype=dtype, k=k), graph).run(
        iterations=iterations)
    rmse1 = rmse_per_edge(graph, dtype, k)
    return graph.vp_numpy()["lv"], rmse0, rmse1


def _main(argv=None):
    """CLI parity with ``src/SGD.cpp``: <ratings.mtx>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = (argv if argv is not None else sys.argv[1:])
    if not args:
        print("Correct format: sgd ratings.mtx")
        return 0
    from ..core.graph import Graph
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    lv, rmse0, rmse1 = run_sgd(g)
    print(f"RMSE error = {rmse0:.6f} per edge (before)")
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"RMSE error = {rmse1:.6f} per edge (after)")
    # first vertices' latent factors, 2 decimals (src/SGD.cpp:244-249)
    for i in range(min(10, g.n)):
        print(f"{i + 1} : " + " ".join(f" {v:.2f}" for v in lv[i]))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
