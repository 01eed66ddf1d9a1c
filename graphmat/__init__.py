"""graphmat — a generalized-SpMV graph analytics framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of GraphMat
(reference: narayanan2004/GraphMat, C++/OpenMP/MPI).  Users write vertex
programs (send_message / process_message / reduce / apply over arbitrary
semirings); the runtime executes each iteration as a masked sparse-matrix ×
sparse-vector product compiled to a single XLA computation, sharded across a
device mesh via ``jax.sharding`` + ``shard_map``.

See SURVEY.md at the repo root for the structural map of the reference and
how each layer corresponds.
"""

from .core.types import (Activity, Direction, Monoid, SUM, MIN, MAX, ANY, LOR,
                         UNTIL_CONVERGENCE)
from .core.graph import Graph
from .core.program import GraphProgram, IterationContext
from .core.runtime import Engine, graph_program_init, run_graph_program
from .io.edgelist import EdgeList, load_edgelist, write_edgelist, \
    edgelist_from_arrays
from .io import transforms


def read_mtx(path, binaryformat=True, header=True, edgeweights=True,
             wdtype=None, **graph_kw):
    """``Graph::ReadMTX`` parity: load an edge list file (or shard prefix)
    and build a :class:`Graph` squared to max(m, n) vertices."""
    import numpy as _np
    kw = dict(binaryformat=binaryformat, header=header,
              edgeweights=edgeweights)
    if wdtype is not None:
        kw["wdtype"] = wdtype
    return Graph(load_edgelist(path, **kw), **graph_kw)

__version__ = "0.1.0"

__all__ = [
    "Activity", "Direction", "Monoid", "SUM", "MIN", "MAX", "ANY", "LOR",
    "UNTIL_CONVERGENCE", "Graph", "GraphProgram", "IterationContext",
    "Engine", "graph_program_init", "run_graph_program",
    "EdgeList", "load_edgelist", "write_edgelist", "edgelist_from_arrays",
    "transforms", "read_mtx",
]
