"""Whole-graph vertex/edge operations.

Device-side implementations of the reference's Graph-level helpers:

* ``applyToAllVertices``  (``Graph.h:353-374``) — elementwise vp transform;
* ``applyReduceAllVertices`` (``Graph.h:377-381`` → MapReduce,
  ``multinode/reduce.h:39-74``) — map over vertices then global reduce;
* ``applyToAllEdges`` (``Graph.h:390-402`` → ApplyEdges,
  ``multinode/applyedges.h:45-161``) — rewrite every edge value as a
  function of both endpoint properties (used for SGD-style edge updates).

The reference keeps A and AT as separate physical copies and runs the edge
update twice with swapped arguments; here both receiver orderings share the
logical edge set, so one vectorized computation per ordering keeps them
consistent.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import tree_util

from .graph import EdgeArrays, Graph

__all__ = ["apply_to_all_vertices", "apply_reduce_all_vertices",
           "apply_to_all_edges"]


def apply_to_all_vertices(graph: Graph, fn: Callable) -> None:
    """vp <- fn(vp) elementwise over valid vertices (pytree -> pytree)."""
    new_vp = fn(graph.vp)
    mask = graph.valid_vertex

    def keep(new, old):
        m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
        return jnp.where(m, new, old)
    graph.vp = tree_util.tree_map(keep, new_vp, graph.vp)


def _reduce_leaf(leaf, mask, red, fetch=None):
    """Reduce one [n_pad, ...] leaf over valid vertices with ``red`` — a
    kind string, a :class:`Monoid`, or an arbitrary associative callable
    ``combine(a, b)`` (the reference MapReduce takes any user reduce fn,
    ``multinode/reduce.h:39-74``).  ``fetch`` pulls a (possibly sharded)
    array to host for the generic path."""
    from .types import Monoid
    if isinstance(red, str):
        red = Monoid(red)
    if isinstance(red, Monoid) and red.kind != "generic":
        op = {"sum": jnp.sum, "min": jnp.min, "any": jnp.min,
              "max": jnp.max,
              "or": lambda a, axis: jnp.any(a, axis=axis)}[red.kind]
        m = mask.reshape(mask.shape + (1,) * (leaf.ndim - 1))
        filled = jnp.where(m, leaf, red.identity(leaf.dtype))
        return op(filled, axis=0)
    # arbitrary combine: log-depth pairwise fold over exactly the valid
    # entries (no identity needed) on host — this is a host-level utility
    # (the reference folds sequentially on rank 0 then broadcasts)
    combine = red.combine if isinstance(red, Monoid) else red
    if fetch is None:
        fetch = jax.device_get
    a = np.asarray(fetch(leaf))[np.asarray(fetch(mask))]
    if a.shape[0] == 0:
        if isinstance(red, Monoid):
            return np.asarray(red.identity(leaf.dtype))
        raise ValueError("empty reduce with no identity — pass a Monoid")
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        folded = np.asarray(combine(a[:half], a[half: 2 * half]))
        a = (np.concatenate([folded, a[2 * half:]], axis=0)
             if a.shape[0] & 1 else folded)
    return a[0]


def reduce_tree(mapped, mask, reduce, fetch=None):
    """Apply :func:`_reduce_leaf` across a mapped pytree; ``reduce`` may be
    a single spec or a pytree of specs matching the mapped structure."""
    from .types import Monoid
    is_spec = lambda x: isinstance(x, (str, Monoid)) or callable(x)
    if is_spec(reduce):
        return tree_util.tree_map(
            lambda lf: _reduce_leaf(lf, mask, reduce, fetch), mapped)
    return tree_util.tree_map(
        lambda r, lf: _reduce_leaf(lf, mask, r, fetch), reduce, mapped,
        is_leaf=is_spec)


def apply_reduce_all_vertices(graph: Graph, map_fn: Callable,
                              reduce="sum"):
    """Global scalar/array reduce of ``map_fn(vp)`` over valid vertices
    (``applyReduceAllVertices``, ``Graph.h:377-381``).

    ``map_fn(vp) -> [n_pad, ...]`` pytree.  ``reduce`` is a kind string
    ('sum'/'min'/'max'/'or'), a :class:`Monoid` (including generic), an
    arbitrary associative ``combine(a, b)`` callable, or a pytree of any
    of these matching the mapped structure.  Returns host values (the
    reference broadcasts the result to all ranks).
    """
    mapped = map_fn(graph.vp)
    mask = graph.valid_vertex
    return jax.device_get(reduce_tree(mapped, mask, reduce))


def apply_to_all_edges(graph: Graph, fn: Callable) -> None:
    """Rewrite edge values: ``val <- fn(vp_src, vp_dst, val)`` for every
    edge, keeping both receiver orderings consistent.

    ``fn`` receives gathered pytrees of the source and destination vertex
    properties ([e_pad] leading dim) and the current values, returns new
    values.  Mirrors ``applyToAllEdges`` running over AT and A with swapped
    arguments (``Graph.h:393-401``).
    """
    def run(ea: EdgeArrays, sender_is_src: bool) -> EdgeArrays:
        vp_s = tree_util.tree_map(lambda a: a[ea.senders], graph.vp)
        vp_r = tree_util.tree_map(lambda a: a[ea.receivers], graph.vp)
        if sender_is_src:
            new_vals = fn(vp_s, vp_r, ea.vals)
        else:
            new_vals = fn(vp_r, vp_s, ea.vals)
        new_vals = jnp.where(ea.valid, new_vals, ea.vals)
        return EdgeArrays(ea.senders, ea.receivers,
                          new_vals.astype(ea.vals.dtype), ea.valid)

    if "dst" in graph._host_edges:
        graph._edge_arrays["dst"] = run(graph.edges_for("dst"),
                                        sender_is_src=True)
    if "src" in graph._host_edges:
        graph._edge_arrays["src"] = run(graph.edges_for("src"),
                                        sender_is_src=False)
