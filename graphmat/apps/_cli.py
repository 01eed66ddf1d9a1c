"""Shared CLI helpers for the app entry points.

Each app module is runnable as ``python -m graphmat.apps.<name>`` with
argument conventions mirroring the reference binaries (``src/*.cpp`` usage
strings), e.g.::

    python -m graphmat.apps.pagerank A.mtx
    python -m graphmat.apps.bfs A.mtx 5
    python -m graphmat.apps.sssp A.mtx 1
    python -m graphmat.apps.delta_stepping A.mtx 3 1
    python -m graphmat.apps.sgd ratings.mtx
    python -m graphmat.apps.lda A.mtx NDOC NTERMS [ITERS]

Multi-device runs keep the exact same CLI (the reference binaries are
likewise unchanged under ``mpirun``): set ``GRAPHMAT_MESH=RxC`` (e.g.
``2x4``) to build the graph 2D-sharded over that device mesh, or
``GRAPHMAT_MESH=auto`` to use every visible device.  The runners pick the
distributed engine from the graph type.
"""

from __future__ import annotations

import os
import time

from ..io.edgelist import load_edgelist
from ..utils.compile_cache import enable_compile_cache

# GRAPHMAT_PLATFORM=cpu|cuda picks the jax platform before the backend
# initializes (the same as JAX_PLATFORMS, for launchers that set their own
# environment).
_plat = os.environ.get("GRAPHMAT_PLATFORM", "").strip()
if _plat:
    import jax
    jax.config.update("jax_platforms", _plat)
enable_compile_cache()


def load_graph_file(path, **kw):
    t0 = time.time()
    e = load_edgelist(path, **kw)
    print(f"Read {e.nnz} edges, {max(e.m, e.n)} vertices "
          f"({time.time() - t0:.2f}s)")
    return e


def build_graph(edgelist, **graph_kw):
    """Graph or DistGraph from ``GRAPHMAT_MESH`` (unset/empty = one device)."""
    spec = os.environ.get("GRAPHMAT_MESH", "").strip().lower()
    if not spec:
        from ..core.graph import Graph
        return Graph(edgelist, **graph_kw)
    import jax

    from ..parallel.dist_graph import DistGraph
    from ..parallel.mesh import factor2d, make_mesh
    devs = jax.devices()
    if spec == "auto":
        shape = factor2d(len(devs))
    else:
        r, c = (int(x) for x in spec.split("x"))
        shape = (r, c)
    mesh = make_mesh(devs[: shape[0] * shape[1]], shape)
    print(f"mesh {shape[0]}x{shape[1]} over {shape[0] * shape[1]} devices")
    return DistGraph(edgelist, mesh, **graph_kw)


def print_first(vals, k: int = 10, label: str = ""):
    for i, v in enumerate(vals[:k], start=1):
        print(f"{label}{i} : {v}")
