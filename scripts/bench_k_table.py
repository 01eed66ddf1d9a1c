"""Per-K cost table for K-wide vector messages.

SGD-CF 1M-rating protocol at several K values, so users can size K.
Slope methodology: per-iter = (t(4R) - t(R)) / 3R, engine end-to-end.

Env: KTAB_KS (comma list, default 8,20,32,40), KTAB_REPS (10).
"""

import os
import time

import numpy as np


def main():
    import jax

    from graphmat import Graph
    from graphmat.apps.sgd import SGDProgram, init_sgd_graph
    from graphmat.core.runtime import Engine
    from graphmat.io.edgelist import EdgeList

    ks = [int(x) for x in os.environ.get(
        "KTAB_KS", "8,20,32,40").split(",")]
    reps = int(os.environ.get("KTAB_REPS", "10"))

    rng = np.random.default_rng(0)
    nu, ni, nr = 60000, 20000, 1_000_000
    n = nu + ni
    us = rng.integers(1, nu + 1, nr).astype(np.int64)
    it = (nu + rng.integers(1, ni + 1, nr)).astype(np.int64)
    val = rng.integers(1, 6, nr).astype(np.float64)
    el = EdgeList(src=us, dst=it, val=val, m=n, n=n)
    g = Graph(el)

    print(f"{'K':>4} {'ms/iter':>8} {'M upd/s':>8}", flush=True)
    for K in ks:
        prog = SGDProgram(k=K)
        init_sgd_graph(g, K)
        g.set_all_active()
        eng = Engine(prog, g)
        ts = {}
        for nit in (reps, 4 * reps):
            init_sgd_graph(g, K)
            g.set_all_active()
            jax.block_until_ready(list(g.vp.values()))
            eng.run(iterations=nit)          # compile + warm
            best = np.inf
            for trial in range(3):
                init_sgd_graph(g, K)
                g.set_all_active()
                jax.block_until_ready(list(g.vp.values()))
                t0 = time.perf_counter()
                eng.run(iterations=nit)
                dt = time.perf_counter() - t0
                if trial:
                    best = min(best, dt)
            ts[nit] = best
        per = (ts[4 * reps] - ts[reps]) / (3 * reps)
        mups = 2 * nr / per / 1e6
        print(f"{K:>4} {per*1e3:8.2f} {mups:8.1f}", flush=True)


if __name__ == "__main__":
    main()
