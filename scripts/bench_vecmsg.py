"""vector_message (concat-reduce) cost measurement.

The engine's variable-length-message facility (GetNeighbors class,
``test/test_get_neighbors.cpp``, serialized wire format
``src/TriangleCounting.cpp:92-109``) runs one XLA scatter into a
``[n_pad, D]`` padded row per receiver.  This benchmarks the
engine step at controlled message widths D: RMAT-18 with receivers
capped to D in-neighbors (so max_degree == D), one engine iteration per
dispatch, best-of-3.

Usage: python scripts/bench_vecmsg.py [D ...]   (default 64 256 1024)
"""

import json
import sys
import time

import numpy as np


def capped_edges(scale, cap, seed=1):
    """RMAT edge list with per-RECEIVER (src role: in-edges of src)
    degree capped to ``cap`` so the concat width is exactly D=cap."""
    from graphmat.io.edgelist import EdgeList
    from graphmat.utils.generators import rmat_edgelist
    e = rmat_edgelist(scale, 16, seed=seed)
    # GetNeighbors is IN_EDGES: receiver = src; cap out-degree of src?
    # receiver role is 'src', messages flow dst -> src, so cap the
    # number of edges sharing one src
    order = np.argsort(e.src, kind="stable")
    s, d, v = e.src[order], e.dst[order], e.val[order]
    b = np.r_[0, np.flatnonzero(s[1:] != s[:-1]) + 1, len(s)]
    keep = np.zeros(len(s), bool)
    for i in range(len(b) - 1):
        keep[b[i]: min(b[i] + cap, b[i + 1])] = True
    return EdgeList(src=s[keep], dst=d[keep], val=v[keep], m=e.m, n=e.n)


def main():
    import jax

    from graphmat import Graph
    from graphmat.apps.get_neighbors import GetNeighborsProgram
    from graphmat.core.runtime import Engine
    from graphmat.ops.neighbors import max_degree

    widths = [int(a) for a in sys.argv[1:]] or [64, 256, 1024]
    for D in widths:
        t0 = time.time()
        e = capped_edges(18, D)
        g = Graph(e, build_out_edges=False)
        dmax = max_degree(g, "src")
        from graphmat.ops.neighbors import PAD_ID
        # neighbors pre-shaped to the concat width: the fori_loop carry
        # must be shape-stable across iterations
        g.init_vertexproperty(
            id=np.arange(1, g.n + 1, dtype=np.int32),
            neighbors=np.full((g.n, dmax), PAD_ID, np.int32))
        g.set_all_active()
        prog = GetNeighborsProgram()
        eng = Engine(prog, g)
        build = time.time() - t0
        # 10 iterations per dispatch amortize the host dispatch cost;
        # ALL_VERTICES re-runs the full concat every iter
        iters = 10
        eng.run(iterations=iters)      # compile + warm
        best = np.inf
        for trial in range(4):
            t0 = time.perf_counter()
            eng.run(iterations=iters)
            dt = (time.perf_counter() - t0) / iters
            if trial:
                best = min(best, dt)
        print(json.dumps({
            "D": D, "max_degree": int(dmax), "nnz": int(g.nnz),
            "n": int(g.n), "ms_per_iter": round(best * 1e3, 2),
            "edges_per_s_M": round(g.nnz / best / 1e6, 1),
            "out_bytes_MB": round(g.n_pad * dmax * 4 / 1e6, 1),
            "build_s": round(build, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
