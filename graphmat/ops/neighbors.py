"""Padded neighbor-list construction and sorted-set intersection.

The reference's TriangleCounting sends *variable-length* neighbor vectors as
messages through Boost-serialized buffers (``src/TriangleCounting.cpp:82-111``,
``DenseSegment.h`` SERIALIZED wire format).  Variable-length payloads don't
exist in a compiled XLA program; the equivalent static-shape design collects each vertex's
neighbor ids into a ``[n_pad, max_degree]`` matrix padded with INT32_MAX —
rows are sorted ascending, so the reference's sorted-vector intersection
(``:127-144``) becomes a vectorized searchsorted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.graph import EdgeArrays, Graph

__all__ = ["max_degree", "collect_neighbors", "intersect_sorted_counts",
           "PAD_ID"]

PAD_ID = np.iinfo(np.int32).max


def max_degree(graph: Graph, receiver: str = "src") -> int:
    """Host-side max receiver degree (a shape, so computed on host)."""
    ea = graph.edges_for(receiver)
    valid = np.asarray(ea.valid)
    r = np.asarray(ea.receivers)[valid]
    if r.size == 0:
        return 1
    return int(np.bincount(r).max())


def collect_neighbors(graph: Graph, receiver: str = "src",
                      pad_to: int | None = None,
                      neighbor_ids=None):
    """Build the padded, row-sorted neighbor matrix on device.

    ``receiver='src'`` collects each vertex's out-neighbors (the reference's
    GetNeighbors runs IN_EDGES so receiver = src, collecting dst ids).

    ``neighbor_ids`` optionally supplies the value to record per edge
    (default: the sender's 1-based vertex id, matching ``vp.id`` messages).
    Returns int32 ``[n_pad, D]`` sorted ascending per row, padded with PAD_ID.
    """
    ea: EdgeArrays = graph.edges_for(receiver)
    D = pad_to if pad_to is not None else max_degree(graph, receiver)
    n_pad = graph.n_pad

    # rank of each edge within its receiver segment: receivers are sorted,
    # so rank = position - first position of this segment.
    e_pad = ea.e_pad
    pos = jnp.arange(e_pad, dtype=jnp.int32)
    seg_start = jax.ops.segment_min(pos, ea.receivers, n_pad,
                                    indices_are_sorted=True)
    rank = pos - seg_start[ea.receivers]

    vals = (ea.senders + 1 if neighbor_ids is None
            else neighbor_ids).astype(jnp.int32)
    row = jnp.where(ea.valid, ea.receivers, n_pad - 1)
    col = jnp.where(ea.valid & (rank < D), rank, D)

    out = jnp.full((n_pad, D + 1), PAD_ID, jnp.int32)
    out = out.at[row, col].set(jnp.where(ea.valid, vals, PAD_ID), mode="drop")
    # senders ascend within a segment (build sorts by (receiver, sender)),
    # so rows are already sorted; padding PAD_ID sorts last naturally.
    return out[:, :D]


def intersect_sorted_counts(a, b):
    """|a ∩ b| per row for ``[e, D]`` ascending rows padded with PAD_ID.

    The reference's two-pointer merge (``src/TriangleCounting.cpp:127-144``)
    recast as a batched binary search: for every element of ``a``, check
    membership in ``b``.  Duplicate-free rows assumed (simple graphs).
    """
    d = b.shape[1]
    idx = jax.vmap(jnp.searchsorted)(b, a)
    idx = jnp.minimum(idx, d - 1)
    found = jnp.take_along_axis(b, idx, axis=1) == a
    valid = a != PAD_ID
    return jnp.sum(found & valid, axis=1).astype(jnp.int32)
