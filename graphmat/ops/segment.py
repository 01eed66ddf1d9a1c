"""Segment reductions over edge arrays — the generalized-SpMV ⊕ stage.

This is the XLA replacement for the reference's per-row merge loops in
``include/GMDP/singlenode/spmspv.h:39-314`` (``y[row] = op_add(y[row], msg)``
guarded by a bitvector).  Edges arrive sorted by receiver vertex, so the
reduction is a sorted-segment reduce:

* named monoids (min/max/or, and integer sums) lower to
  ``jax.ops.segment_*`` with ``indices_are_sorted=True`` — XLA emits a
  scatter-reduce, whose atomics give the same answer in any order;
* float sums and arbitrary associative combines use a segmented
  ``lax.associative_scan`` (log-depth, static shapes, a fixed summation
  order) — the fully general ``reduce_function`` path.

Pytree-valued messages reduce leaf-wise; a monoid pytree may be supplied to
give different ⊕ per leaf (mirrors struct-typed reduced messages like
BFS's (depth, parent)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import tree_util

from ..core.types import Monoid

__all__ = [
    "segment_reduce",
    "segment_reduce_tree",
    "segment_any",
    "segment_concat",
    "segment_concat_tree",
    "masked_fill_identity",
]


def _leaf_segment_reduce(monoid: Monoid, data, seg_ids, num_segments,
                         indices_are_sorted=True):
    kind = monoid.kind
    if kind == "sum":
        if (indices_are_sorted and data.shape[0]
                and jnp.issubdtype(data.dtype, jnp.floating)):
            # a float scatter-add runs on atomics on a GPU, so its result
            # depends on the order the updates land in and changes from
            # run to run; PageRank's |Δ| <= 1e-5 test then never holds
            # for hub vertices.  The flagged scan sums every segment in
            # one fixed order.
            return _generic_segment_reduce(monoid, data, seg_ids,
                                           num_segments)
        return jax.ops.segment_sum(data, seg_ids, num_segments,
                                   indices_are_sorted=indices_are_sorted)
    if kind in ("min", "any"):
        return jax.ops.segment_min(data, seg_ids, num_segments,
                                   indices_are_sorted=indices_are_sorted)
    if kind == "max":
        return jax.ops.segment_max(data, seg_ids, num_segments,
                                   indices_are_sorted=indices_are_sorted)
    if kind == "or":
        red = jax.ops.segment_max(data.astype(jnp.int32), seg_ids, num_segments,
                                  indices_are_sorted=indices_are_sorted)
        return red > 0
    if kind == "generic":
        return _generic_segment_reduce(monoid, data, seg_ids, num_segments)
    raise ValueError(f"unknown monoid kind {kind}")


def _generic_segment_reduce(monoid: Monoid, data, seg_ids, num_segments):
    """Sorted-segment reduce for an arbitrary associative combine.

    Uses the classic flagged-scan construction: scan the pairs
    ``(segment_start_flag, value)`` with an operator that restarts at flags;
    the running value at each segment's last position is the segment total,
    scattered to its segment id (out-of-range ids drop).
    """
    e = data.shape[0]
    flags = jnp.ones((e,), bool).at[1:].set(seg_ids[1:] != seg_ids[:-1])

    def op(a, b):
        fa, va = a
        fb, vb = b
        v = jnp.where(_bcast(fb, vb), vb, monoid.combine(va, vb))
        return jnp.logical_or(fa, fb), v

    _, scanned = jax.lax.associative_scan(op, (flags, data))
    is_last = jnp.ones((e,), bool).at[:-1].set(seg_ids[1:] != seg_ids[:-1])
    out_ids = jnp.where(is_last, seg_ids, num_segments)  # drop non-lasts
    ident = monoid.identity(data.dtype)
    out = jnp.full((num_segments,) + data.shape[1:], ident, data.dtype)
    return out.at[out_ids].set(scanned, mode="drop")


def _bcast(mask, like):
    """Broadcast a 1-D edge mask against trailing feature dims."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def segment_reduce(monoid: Monoid, data, seg_ids, num_segments,
                   indices_are_sorted=True):
    """Reduce ``data`` (leading edge dim) into ``num_segments`` buckets."""
    return _leaf_segment_reduce(monoid, data, seg_ids, num_segments,
                                indices_are_sorted)


def segment_reduce_tree(monoid, data_tree, seg_ids, num_segments,
                        indices_are_sorted=True):
    """Leaf-wise segment reduce of a pytree.

    ``monoid`` is a single :class:`Monoid` applied to every leaf, or a pytree
    of monoids matching ``data_tree``.
    """
    if isinstance(monoid, Monoid):
        return tree_util.tree_map(
            lambda leaf: _leaf_segment_reduce(monoid, leaf, seg_ids,
                                              num_segments, indices_are_sorted),
            data_tree)
    return tree_util.tree_map(
        lambda m, leaf: _leaf_segment_reduce(m, leaf, seg_ids, num_segments,
                                             indices_are_sorted),
        monoid, data_tree)


def segment_any(mask, seg_ids, num_segments, indices_are_sorted=True):
    """Per-segment logical OR of a boolean edge mask (→ ``got_message``).

    The analog of the reference's y-bitvector set during the merge
    (``singlenode/spmspv.h:70-76``).
    """
    red = jax.ops.segment_max(mask.astype(jnp.int32), seg_ids, num_segments,
                              indices_are_sorted=indices_are_sorted)
    return red > 0


def segment_concat(data, ok, seg_ids, num_segments, width, pad):
    """Concat-reduce: collect each segment's OK contributions into a
    static-width padded row — the static-shape form of the reference's
    variable-length ``Serializable`` messages reduced by vector append
    (``src/TriangleCounting.cpp:92-109``, SERIALIZED wire format
    ``DenseSegment.h:230-358``).

    ``data``: [e_pad, ...] contributions, receiver-sorted; ``ok``: bool
    [e_pad] (sender sent AND edge valid); ``width``: static row width
    (contributions beyond it DROP — callers size it to the max in-degree);
    ``pad``: fill value.  Returns ``[num_segments, width, ...]``; each
    row's first k slots are its k OK contributions in edge order (the
    reference's concat order is likewise unspecified — sort in apply if
    order matters).
    """
    e_pad = data.shape[0]
    okx = ok.astype(jnp.int32)
    # rank of each OK edge among its segment's OK edges: exclusive cumsum
    # minus the segment's base (receivers sorted => cumsum nondecreasing)
    c = jnp.cumsum(okx) - okx
    base = jax.ops.segment_min(c, seg_ids, num_segments,
                               indices_are_sorted=True)
    rank = c - base[seg_ids]
    row = jnp.where(ok, seg_ids, num_segments - 1)
    col = jnp.where(ok & (rank < width), rank, width)
    out = jnp.full((num_segments, width + 1) + data.shape[1:], pad,
                   data.dtype)
    out = out.at[row, col].set(
        jnp.where(_bcast(ok, data), data,
                  jnp.asarray(pad, data.dtype)), mode="drop")
    return out[:, :width]


def segment_concat_tree(data_tree, ok, seg_ids, num_segments, width, pad):
    """Leaf-wise :func:`segment_concat` (``pad`` casts to each leaf)."""
    return tree_util.tree_map(
        lambda leaf: segment_concat(leaf, ok, seg_ids, num_segments,
                                    width, pad), data_tree)


def masked_fill_identity(monoid, data_tree, mask):
    """Replace entries where ``mask`` is False with the monoid identity.

    Used to null out contributions from edges whose sender did not send
    (inactive or send_message returned False) — the reference skips those
    columns entirely via the x bitvector (``singlenode/spmspv.h:55-58``).
    """
    def fill(m: Monoid, leaf):
        ident = m.identity(leaf.dtype)
        return jnp.where(_bcast(mask, leaf), leaf, ident)

    if isinstance(monoid, Monoid):
        return tree_util.tree_map(lambda leaf: fill(monoid, leaf), data_tree)
    return tree_util.tree_map(fill, monoid, data_tree)
