"""Edge-list transformations (dataset preparation).

Vectorized numpy re-design of GraphMat's per-edge loops in
``include/GMDP/utils/edgelist_transformation.h:37-443``.  The reference runs
these as OpenMP/MPI shuffles; here each transform is a whole-array numpy
operation (the multi-host path shards the edge list by file instead — see
``graphmat.io.edgelist.load_edgelist``).

All functions are pure: they return a new :class:`EdgeList`.
"""

from __future__ import annotations

import numpy as np

from .edgelist import EdgeList

__all__ = [
    "remove_selfedges",
    "remove_duplicate_edges",
    "create_bidirectional_edges",
    "convert_to_dag",
    "convert_to_upper_triangular",
    "randomize_edge_direction",
    "random_edge_weights",
    "unit_edge_weights",
    "filter_edges",
    "randomize_vertex_ids",
]


def remove_selfedges(e: EdgeList) -> EdgeList:
    """Drop edges with src == dst (``edgelist_transformation.h:38-53``)."""
    keep = e.src != e.dst
    return EdgeList(e.m, e.n, e.src[keep], e.dst[keep], e.val[keep])


def remove_duplicate_edges(e: EdgeList) -> EdgeList:
    """Sort by (src, dst) and keep the first of each duplicate pair
    (``edgelist_transformation.h:69-95``: stable sort, first occurrence wins).
    """
    if e.nnz == 0:
        return e.copy()
    order = np.lexsort((e.dst, e.src))
    src, dst, val = e.src[order], e.dst[order], e.val[order]
    keep = np.ones(src.shape[0], bool)
    keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    return EdgeList(e.m, e.n, src[keep], dst[keep], val[keep])


def create_bidirectional_edges(e: EdgeList) -> EdgeList:
    """Add the reverse of every edge, same value
    (``edgelist_transformation.h:397-411``).
    """
    # Interleave (fwd, rev) pairs like the reference so downstream dedup
    # keeps deterministic winners.
    src = np.empty(2 * e.nnz, np.int32)
    dst = np.empty(2 * e.nnz, np.int32)
    val = np.empty(2 * e.nnz, e.val.dtype)
    src[0::2], dst[0::2], val[0::2] = e.src, e.dst, e.val
    src[1::2], dst[1::2], val[1::2] = e.dst, e.src, e.val
    return EdgeList(e.m, e.n, src, dst, val)


def convert_to_dag(e: EdgeList) -> EdgeList:
    """Orient every edge low-id -> high-id (``edgelist_transformation.h:413-420``)."""
    swap = e.src > e.dst
    src = np.where(swap, e.dst, e.src).astype(np.int32)
    dst = np.where(swap, e.src, e.dst).astype(np.int32)
    return EdgeList(e.m, e.n, src, dst, e.val.copy())


def convert_to_upper_triangular(e: EdgeList) -> EdgeList:
    """DAG-orient then drop self loops and duplicates — the standard
    TriangleCounting preprocessing (``src/graph_converter.cpp`` upper-tri path).
    """
    return remove_duplicate_edges(remove_selfedges(convert_to_dag(e)))


def randomize_edge_direction(e: EdgeList, seed: int = 0) -> EdgeList:
    """Flip each edge's direction with probability 1/2
    (``edgelist_transformation.h:388-395``; reference uses unseeded rand()).
    """
    rng = np.random.default_rng(seed)
    swap = rng.random(e.nnz) < 0.5
    src = np.where(swap, e.dst, e.src).astype(np.int32)
    dst = np.where(swap, e.src, e.dst).astype(np.int32)
    return EdgeList(e.m, e.n, src, dst, e.val.copy())


def random_edge_weights(e: EdgeList, random_range: int, seed: int = 0,
                        wdtype=None) -> EdgeList:
    """Uniform random weights in [1, random_range]
    (``edgelist_transformation.h:422-430``).
    """
    rng = np.random.default_rng(seed)
    wdtype = np.dtype(wdtype) if wdtype is not None else e.val.dtype
    t = rng.random(e.nnz) * random_range
    t = np.clip(t, 1.0, random_range)
    return EdgeList(e.m, e.n, e.src.copy(), e.dst.copy(), t.astype(wdtype))


def unit_edge_weights(e: EdgeList, wdtype=None) -> EdgeList:
    wdtype = np.dtype(wdtype) if wdtype is not None else e.val.dtype
    return EdgeList(e.m, e.n, e.src.copy(), e.dst.copy(),
                    np.ones(e.nnz, wdtype))


def filter_edges(e: EdgeList, predicate) -> EdgeList:
    """Keep edges where ``predicate(src, dst, val) -> bool mask`` holds.

    Vectorized analog of ``filter_edges`` (``edgelist_transformation.h:432-443``):
    the predicate receives the full arrays and returns a boolean mask, e.g.
    ``lambda s, d, v: v <= delta`` for DeltaStepping's light-edge split.
    """
    keep = np.asarray(predicate(e.src, e.dst, e.val), bool)
    return EdgeList(e.m, e.n, e.src[keep], e.dst[keep], e.val[keep])


def randomize_vertex_ids(e: EdgeList, seed: int = 5) -> tuple:
    """Apply a random permutation to vertex ids of a square edge list.

    BIT-PARITY analog of ``randomize_edgelist_square``
    (``edgelist.h:337-366``): the permutation is the reference's exact
    ``srand(seed)`` + ``rand() % m`` sequential-swap mapping (glibc
    TYPE_3 ``rand()`` replicated in ``utils.reference_rng`` /
    ``native/planner.cpp``), so the remapped edge list is byte-identical
    to the reference converter's output on the same input.  Returns
    ``(new_edgelist, perm)`` where ``perm[old_1based - 1] = new_1based``.
    """
    if e.m != e.n:
        raise ValueError("randomize_vertex_ids requires a square edge list")
    from ..native import load_planner
    lib = load_planner()
    if lib is not None and hasattr(lib, "gm_glibc_square_mapping"):
        mapping = np.empty(e.m, np.int32)
        lib.gm_glibc_square_mapping(int(e.m), np.uint32(seed), mapping)
    else:
        from ..utils.reference_rng import glibc_square_mapping_np
        mapping = glibc_square_mapping_np(int(e.m), seed).astype(np.int32)
    perm = mapping + 1                      # 1-based new ids
    src = perm[e.src - 1]
    dst = perm[e.dst - 1]
    return EdgeList(e.m, e.n, src, dst, e.val.copy()), perm
