"""GetNeighbors — the variable-length-message (vector-message) program.

Port of the reference's end-to-end SERIALIZED-wire-format exercise
(``test/test_get_neighbors.cpp:64-137``): every vertex sends its id, the
⊕ is a LIST CONCAT (``reduce_function`` appends vectors, ``:74-77``), and
``apply`` stores the sorted neighbor list.  Here the concat rides the
engine's ``vector_message`` facility: each receiver collects its
contributions into a static-width padded row (pad = INT32_MAX), so
``apply`` receives ``[n_pad, D]`` — the static-shape form of growable
``Serializable`` payloads, and the same facility a user program with
list-valued messages writes against.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction
from ..ops.neighbors import PAD_ID

__all__ = ["GetNeighborsProgram", "run_get_neighbors", "PAD_ID"]


class GetNeighborsProgram(GraphProgram):
    """Collect, per vertex, the ids of its out-neighbors.

    IN_EDGES + ALL_VERTICES like the reference (`test_get_neighbors.cpp:
    67-72`): messages travel against edge direction, so vertex v receives
    the id of every w with an edge (v -> w).
    """

    order = Direction.IN_EDGES
    activity = Activity.ALL_VERTICES
    process_requires_vertexprop = False
    vector_message = True
    vector_pad = PAD_ID

    def send_message(self, state, vp):
        return vp["id"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        # reduced: [n_pad, D] int32 padded with PAD_ID; the reference
        # sorts in apply (:91-94) — pads sort last naturally
        return {"id": vp["id"], "neighbors": jnp.sort(reduced, axis=1)}

    def changed(self, old_vp, new_vp):
        # the reference's operator!= compares id only (:47-49)
        return old_vp["id"] != new_vp["id"]


def run_get_neighbors(graph):
    """Run GetNeighbors for one iteration; returns the ``[n, D]`` sorted
    neighbor-id matrix (PAD_ID-padded) in ORIGINAL vertex order."""
    prog = GetNeighborsProgram()
    eng = engine_for(prog, graph)
    D = eng.vector_reduced_width
    ids = np.arange(1, graph.n + 1, dtype=np.int32)
    graph.init_vertexproperty(
        id=ids, neighbors=np.full((graph.n, D), PAD_ID, np.int32))
    eng.run(iterations=1)
    return graph.vp_numpy()["neighbors"]
