"""Distributed whole-graph operations on a :class:`DistGraph`.

The 2D-mesh analogs of the reference's multinode primitives outside the
iteration driver:

* ``apply_to_all_vertices``   — ``Apply``       (multinode/apply.h:39-49)
* ``apply_reduce_all_vertices`` — ``MapReduce`` (multinode/reduce.h:39-74;
  the rank-0 fold + Bcast becomes a replicated XLA reduce)
* ``apply_to_all_edges``      — ``ApplyEdges``  (multinode/applyedges.h:45-161;
  the vertex-property row/col broadcast becomes all_gather over the mesh
  axes, the in-place tile mutation a sharded elementwise rewrite)

Semantics mirror :mod:`graphmat.core.graph_ops` exactly; tests compare
the two on the same inputs.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, tree_util
from jax.sharding import PartitionSpec as P

from .dist_graph import DistEdgeTiles, DistGraph
from .mesh import COL_AXIS, ROW_AXIS

__all__ = ["apply_to_all_vertices", "apply_reduce_all_vertices",
           "apply_to_all_edges"]


def apply_to_all_vertices(graph: DistGraph, fn: Callable) -> None:
    """vp <- fn(vp) elementwise over valid vertices (pytree -> pytree)."""
    new_vp = fn(graph.vp)
    mask = graph.valid_vertex

    def keep(new, old):
        m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
        return jnp.where(m, new, old)
    graph.vp = tree_util.tree_map(keep, new_vp, graph.vp)


def apply_reduce_all_vertices(graph: DistGraph, map_fn: Callable,
                              reduce="sum"):
    """Global reduce of ``map_fn(vp)`` over valid vertices; host values.

    ``reduce`` matches :func:`core.graph_ops.apply_reduce_all_vertices`
    (kind string, Monoid, arbitrary associative callable, or a pytree of
    these).  Fast-path kinds reduce the mesh-sharded array in place (XLA
    inserts the collectives — the analog of the reference's fold-at-rank-0
    + MPI_Bcast); generic combines fold on host over gathered values.
    """
    from ..core.graph_ops import reduce_tree
    mapped = map_fn(graph.vp)
    mask = graph.valid_vertex
    return jax.device_get(reduce_tree(mapped, mask, reduce,
                                      fetch=graph._fetch))


def apply_to_all_edges(graph: DistGraph, fn: Callable) -> None:
    """Rewrite edge values: ``val <- fn(vp_src, vp_dst, val)``, both tile
    orderings kept consistent (``Graph.h:393-401`` runs AT then A with
    swapped arguments).

    Per tile (i, j): senders live in column block j (vp all_gathered down
    the row axis), receivers in row block i (vp all_gathered down the
    column axis) — the same exchange the reference's ApplyEdges does with
    MPI broadcasts to row/col rank sets.
    """
    mesh = graph.mesh
    vp_spec = tree_util.tree_map(lambda _: P((ROW_AXIS, COL_AXIS)),
                                 graph.vp)
    tile_p = P((ROW_AXIS, COL_AXIS))

    def run(tiles: DistEdgeTiles, sender_is_src: bool) -> DistEdgeTiles:
        def local(vp, senders, receivers, vals, valid):
            s, r, v, ok = senders[0], receivers[0], vals[0], valid[0]
            vp_send = tree_util.tree_map(
                lambda a: lax.all_gather(a, ROW_AXIS, tiled=True), vp)
            vp_recv = tree_util.tree_map(
                lambda a: lax.all_gather(a, COL_AXIS, tiled=True), vp)
            vs = tree_util.tree_map(lambda a: a[s], vp_send)
            vr = tree_util.tree_map(lambda a: a[r], vp_recv)
            new = fn(vs, vr, v) if sender_is_src else fn(vr, vs, v)
            return jnp.where(ok, new, v).astype(v.dtype)[None]

        f = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(vp_spec, tile_p, tile_p, tile_p, tile_p),
            out_specs=tile_p, check_vma=False))
        new_vals = f(graph.vp, tiles.senders, tiles.receivers, tiles.vals,
                     tiles.valid)
        return DistEdgeTiles(tiles.senders, tiles.receivers, new_vals,
                             tiles.valid)

    if graph.out_tiles is not None:
        graph.out_tiles = run(graph.out_tiles, sender_is_src=True)
    if graph.in_tiles is not None:
        graph.in_tiles = run(graph.in_tiles, sender_is_src=False)

    # refresh host tile copies (get_edges reads them) by re-applying fn
    # on host-reconstructed global ids
    vp_host = {k: graph._fetch(v) for k, v in graph.vp.items()}
    C, S = graph.C, graph.S
    for recv, tiles in list(graph._host_tiles.items()):
        sender_is_src = recv == "dst"
        out = []
        for t, (s_loc, r_loc, v) in enumerate(tiles):
            ti, tj = t // C, t % C
            s_glob = ((s_loc // S) * C + tj) * S + (s_loc % S)
            r_glob = ti * (C * S) + r_loc
            vs = {k: a[s_glob] for k, a in vp_host.items()}
            vr = {k: a[r_glob] for k, a in vp_host.items()}
            if len(v):
                new = fn(vs, vr, v) if sender_is_src else fn(vr, vs, v)
                v = np.asarray(new).astype(v.dtype)
            out.append((s_loc, r_loc, v))
        graph._host_tiles[recv] = out
