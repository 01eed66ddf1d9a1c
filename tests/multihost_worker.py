"""Multi-process worker for test_multihost.py (the ``mpirun -np N`` rank).

Each process owns 4 virtual CPU devices; jax.distributed + Gloo provide
the cross-process collectives.  Process 0 writes the final vertex
properties for the parent test to compare against the single-device
engine.  Usage: worker.py <pid> <nproc> <port> <outfile>
"""

import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    pid, nproc, port, outfile = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
    from graphmat.apps.bfs import BFSProgram
    from graphmat.apps.pagerank import DegreeProgram, PageRankProgram
    from graphmat.parallel.dist_graph import DistGraph
    from graphmat.parallel.dist_runtime import DistEngine
    from graphmat.parallel.multihost import (allgather_edgelist,
                                             hosts_mesh,
                                             load_edgelist_sharded)
    from graphmat.utils.generators import rmat_edgelist

    mesh = hosts_mesh()
    assert mesh.devices.shape[0] == nproc, mesh.devices.shape
    shard_prefix = sys.argv[5] if len(sys.argv) > 5 else ""
    if shard_prefix:
        # distributed ingest: host h reads shards {h, h+H, ...} then the
        # partial lists are exchanged (the reference's load + shuffle)
        mine = load_edgelist_sharded(shard_prefix, binaryformat=False)
        e = allgather_edgelist(mine)
    else:
        e = rmat_edgelist(8, 8, seed=3)

    # PageRank (ALL_VERTICES, sum)
    g = DistGraph(e, mesh, seg_align=8)
    g.init_vertexproperty(pagerank=np.float32(0.3), degree=np.int32(0))
    g.set_all_active()
    DistEngine(DegreeProgram(), g).run(iterations=1)
    pr_iters = DistEngine(PageRankProgram(), g).run()
    pr = g.vp_numpy()["pagerank"]

    # BFS (ACTIVE_ONLY, min) — exercises the frontier path cross-process
    g2 = DistGraph(e, mesh, seg_align=8)
    ids = np.arange(1, g2.n + 1, dtype=np.int32)
    inf = np.int32(np.iinfo(np.int32).max)
    g2.init_vertexproperty(depth=inf, parent=np.int32(-1), id=ids)
    g2.set_all_inactive()
    g2.set_vertexproperty(1, depth=0)
    g2.set_active(1)
    bfs_iters = DistEngine(BFSProgram(), g2).run()
    depth = g2.vp_numpy()["depth"]

    if pid == 0:
        np.savez(outfile, pagerank=pr, depth=depth,
                 pr_iters=pr_iters, bfs_iters=bfs_iters)
        print("worker0 wrote", outfile, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
