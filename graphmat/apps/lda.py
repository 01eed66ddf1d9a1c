"""Collapsed variational LDA on a doc-term bipartite graph
(reference: ``src/LDA.cpp``).

Vertices 1..ndoc are documents, ndoc+1..ndoc+nterms are terms; edges carry
token counts and exist in both directions (ALL_EDGES + ALL_VERTICES).
Vertex property ``N[K]`` holds per-topic expected counts; the global topic
totals ``global_N[K]`` (a cross-shard reduce over term vertices) live in
program state and are recomputed in ``do_every_iteration``
(:144-147,190-192) — on the mesh this folds a psum into the compiled step.

* **LDAInitProgram** (:70-112): per-edge gamma seeded by ``rand_r(edge
  value)`` so both directions of an edge agree (bit-exact glibc LCG replica,
  ``utils.reference_rng``); ``res = gamma/Σgamma · count``; apply overwrites N.
* **LDAProgram** (:128-194): gamma ∝ ``(N_recv + off_r − 1)(N_send + off_s −
  1) / (global_N + V(eta−1))`` with (α, η) offsets chosen by the receiver's
  side; α=1, η=5 (:292-293).
* **LDALLProgram** (:196-250): per-vertex token log-likelihood given
  smoothed topic-word distributions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM
from ..utils.reference_rng import rand_r_jnp

__all__ = ["LDAInitProgram", "LDAProgram", "LDALLProgram", "run_lda"]


class LDAInitProgram(GraphProgram):
    order = Direction.ALL_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = False

    def __init__(self, k: int = 20, dtype=jnp.float32):
        self.k = k
        self.dtype = dtype

    def send_message(self, state, vp):
        return vp["N"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        gamma = rand_r_jnp(edge_vals.astype(jnp.uint32), self.k,
                           dtype=self.dtype)
        gamma = gamma / jnp.sum(gamma, axis=1, keepdims=True)
        return gamma * edge_vals.astype(self.dtype)[:, None]

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["N"] = reduced
        return out


def _global_topic_totals(vp, ctx, dtype):
    """Σ over term ('w') vertices of N — ``calcGlobalN`` (:140-143)."""
    is_term = ~vp["is_doc"]
    local = jnp.sum(jnp.where(is_term[:, None], vp["N"],
                              jnp.array(0, dtype)), axis=0)
    return ctx.all_reduce_sum(local)


class LDAProgram(GraphProgram):
    order = Direction.ALL_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def __init__(self, k: int = 20, alpha: float = 1.0, eta: float = 5.0,
                 vocab_size: int = 0, dtype=jnp.float32):
        self.k = k
        self.alpha = alpha
        self.eta = eta
        self.vocab_size = vocab_size
        self.dtype = dtype

    def init_state(self, graph):
        # global_N; caller should refresh via calc_global_n before running
        return jnp.zeros((self.k,), self.dtype)

    def send_message(self, state, vp):
        return {"N": vp["N"]}, None

    def process_message(self, state, msg, edge_vals, vp_r):
        global_n = state
        my_off = jnp.where(vp_r["is_doc"], jnp.array(self.alpha, self.dtype),
                           jnp.array(self.eta, self.dtype))[:, None]
        other_off = jnp.where(vp_r["is_doc"], jnp.array(self.eta, self.dtype),
                              jnp.array(self.alpha, self.dtype))[:, None]
        denom = global_n + self.vocab_size * (self.eta - 1.0)
        gamma = ((vp_r["N"] + my_off - 1.0) * (msg["N"] + other_off - 1.0)
                 / denom[None, :])
        gamma = gamma / jnp.sum(gamma, axis=1, keepdims=True)
        return gamma * edge_vals.astype(self.dtype)[:, None]

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["N"] = reduced
        return out

    def changed(self, old_vp, new_vp):
        # operator!= tolerance 1e-3 on N (:52-58)
        return jnp.any(jnp.abs(old_vp["N"] - new_vp["N"]) > 1e-3, axis=1)

    def do_every_iteration(self, state, vp, it, ctx):
        return _global_topic_totals(vp, ctx, self.dtype)


class LDALLProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def __init__(self, n_k, eta: float, nterms: int, k: int = 20,
                 dtype=jnp.float32):
        self.k = k
        self.eta = eta
        # smoothed N_k (:176-181)
        self.n_k_smoothed = jnp.asarray(np.asarray(n_k)
                                        + nterms * (eta - 1.0), dtype)
        self.dtype = dtype

    def send_message(self, state, vp):
        return {"N": vp["N"]}, None

    def process_message(self, state, msg, edge_vals, vp_r):
        phi = (vp_r["N"] + (self.eta - 1.0)) / self.n_k_smoothed[None, :]
        theta = msg["N"] + (self.eta - 1.0)
        theta = theta / jnp.sum(theta, axis=1, keepdims=True)
        dot = jnp.sum(phi * theta, axis=1)
        return edge_vals.astype(self.dtype) * jnp.log(dot)

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["token_loglik"] = reduced
        return out


def run_lda(graph: Graph, ndoc: int, nterms: int, k: int = 20,
            iterations: int = 10, alpha: float = 1.0, eta: float = 5.0,
            dtype=jnp.float32):
    """Full reference flow (:263-345).

    Returns ``(N[n,k], global_N[k], total_loglik)``.
    """
    if ndoc + nterms != graph.n:
        raise ValueError("ndoc + nterms must equal the vertex count "
                         "(src/LDA.cpp:268-271)")
    is_doc = np.zeros(graph.n, bool)
    is_doc[:ndoc] = True
    graph.init_vertexproperty(
        N=np.zeros((graph.n, k), np.dtype(dtype)),
        is_doc=is_doc,
        token_loglik=np.array(0, np.dtype(dtype)),
    )

    engine_for(LDAInitProgram(k, dtype=dtype), graph).run(iterations=1)

    prog = LDAProgram(k, alpha, eta, vocab_size=nterms, dtype=dtype)
    eng = engine_for(prog, graph)
    # ldap.calcGlobalN() before the run (:279) — computed on host from
    # the exported (unpermuted, unsharded) properties: ctx collectives
    # are only legal inside the traced step, and this one-time reduce is
    # not on the hot path
    vpn = graph.vp_numpy()
    global_n = jnp.asarray(
        vpn["N"][~vpn["is_doc"].astype(bool)].sum(axis=0), dtype)
    eng.run(iterations=iterations, state=global_n)
    global_n = jnp.asarray(eng.final_state)

    ll_prog = LDALLProgram(global_n, eta, nterms, k, dtype=dtype)
    engine_for(ll_prog, graph).run(iterations=1)
    vp = graph.vp_numpy()
    total_ll = float(vp["token_loglik"].sum())
    return vp["N"], np.asarray(global_n), total_ll


def _main(argv=None):
    """CLI parity with ``src/LDA.cpp``: <A.mtx> <NDOC> <NTERMS> [iters]."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = (argv if argv is not None else sys.argv[1:])
    if len(args) < 3:
        print("Correct format: lda A.mtx #DOC #TERMS {#iterations (default 10)}")
        return 0
    from ..core.graph import Graph
    g = build_graph(load_graph_file(args[0]))
    iters = int(args[3]) if len(args) > 3 else 10
    t0 = time.time()
    N, gN, ll = run_lda(g, int(args[1]), int(args[2]), iterations=iters)
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Total Loglikelihood = {ll:.6f}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
