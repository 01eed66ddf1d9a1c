"""Weak-scaling harness: PageRank over growing meshes.

Usage (virtual CPU devices, the mpirun analog)::

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/weak_scaling.py --platform cpu --scale 14

On real multi-GPU hardware drop ``--platform cpu``.  Keeps the per-device
edge count constant (RMAT scale grows with the mesh) and reports iterations
per second and weak-scaling efficiency vs the 1-device run — the
reference-equivalent metric is BASELINE.md's >=80% at 1->4 hosts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=14,
                    help="RMAT scale per device (vertices = 2^scale * ndev)")
    ap.add_argument("--edgefactor", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--max-devices", type=int, default=None)
    ap.add_argument("--workloads", default="pagerank,sgd",
                    help="comma list: pagerank (scalar messages), sgd "
                         "(K-wide messages + vp row-broadcast)")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import numpy as np

    from graphmat.apps.pagerank import DegreeProgram, PageRankProgram
    from graphmat.parallel.dist_graph import DistGraph
    from graphmat.parallel.dist_runtime import DistEngine
    from graphmat.parallel.mesh import factor2d, make_mesh
    from graphmat.utils.generators import rmat_edgelist

    devices = jax.devices()
    counts = []
    d = 1
    while d <= len(devices) and (args.max_devices is None
                                 or d <= args.max_devices):
        counts.append(d)
        d *= 2

    import math

    from graphmat.io.edgelist import EdgeList

    workloads = args.workloads.split(",")
    results = []
    base_rate = {}
    for nd in counts:
        extra = int(math.log2(nd))
        mesh = make_mesh(devices[:nd], factor2d(nd))
        R, C = mesh.devices.shape

        runs = []
        if "pagerank" in workloads:
            e = rmat_edgelist(args.scale + extra, args.edgefactor, seed=7)
            g = DistGraph(e, mesh, permute="degree")
            g.init_vertexproperty(pagerank=np.float32(0.3),
                                  degree=np.int32(0))
            g.set_all_active()
            DistEngine(DegreeProgram(), g).run(iterations=1)
            eng = DistEngine(PageRankProgram(), g)
            S = g.S
            # analytic per-device per-iteration collective bytes
            # (f32 msg all_gather 'r', f32 partial psum_scatter 'c',
            # 4-byte convergence psum) — the wire cost the reference
            # pays via compressed Isend/Irecv (multinode/spmspv.h)
            coll = {"all_gather_r_bytes": int((R - 1) * S * 4),
                    "psum_scatter_c_bytes": int((C - 1) * S * 4),
                    "convergence_psum_bytes": 4}
            runs.append(("pagerank", e.nnz, g, eng, coll))
        if "sgd" in workloads:
            # bipartite ratings scaled per device; K=20
            K = 20
            rng = np.random.default_rng(13 + nd)
            nu = (1 << (args.scale - 2)) * nd
            ni = max(nu // 3, 8)
            nr = args.edgefactor * (nu + ni)
            n2 = nu + ni
            el = EdgeList(src=rng.integers(1, nu + 1, nr),
                          dst=(nu + rng.integers(1, ni + 1, nr)),
                          val=rng.integers(1, 6, nr).astype(np.float64),
                          m=n2, n=n2)
            g2 = DistGraph(el, mesh)
            from graphmat.apps.sgd import SGDProgram, init_sgd_graph
            init_sgd_graph(g2, K)
            g2.set_all_active()
            eng2 = DistEngine(SGDProgram(k=K), g2)
            S2 = g2.S
            # collective model: K-wide msg all_gather 'r', K-wide vp
            # row-broadcast all_gather 'c' (SpMSpV3's second operand,
            # multinode/spmspv3.h:74-143), K-wide partial psum_scatter 'c'
            coll2 = {"all_gather_r_bytes": int((R - 1) * S2 * K * 4),
                     "vp_all_gather_c_bytes": int((C - 1) * S2 * K * 4),
                     "psum_scatter_c_bytes": int((C - 1) * S2 * K * 4),
                     "convergence_psum_bytes": 4}
            runs.append(("sgd", el.nnz, g2, eng2, coll2))

        for (wname, nnz, gg, eng, coll) in runs:
            eng.run(iterations=args.iters)  # warm-up/compile
            best = float("inf")
            for _ in range(3):
                t0 = time.time()
                eng.run(iterations=args.iters)
                best = min(best, time.time() - t0)
            rate = nnz * args.iters / best / 1e9
            if wname not in base_rate:
                base_rate[wname] = rate / nd if nd == 1 else rate
            eff = rate / (base_rate[wname] * nd)
            results.append({
                "workload": wname, "devices": nd,
                "mesh": [int(R), int(C)], "nnz": int(nnz),
                "gteps": round(rate, 4), "efficiency": round(eff, 3),
                "collectives_per_iter_per_device": coll})
            print(json.dumps(results[-1]))
    print(json.dumps({"weak_scaling": results,
                      "backend": jax.default_backend(),
                      "note": ("virtual CPU devices validate the sharded "
                               "dataflow; efficiency needs real devices")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
