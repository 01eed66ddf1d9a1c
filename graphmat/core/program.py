"""The GraphProgram vertex-program API.

JAX-traceable re-design of the reference's abstract ``GraphProgram<T,U,V,E>``
(``include/GraphProgram.h:38-101``).  The four virtuals become pure,
*vectorized* jnp functions operating on whole arrays (leading dim = vertices
or edges) instead of per-element C++ callbacks:

==============================  =============================================
reference (per element)          here (vectorized, pure)
==============================  =============================================
``bool send_message(V, T&)``     ``send_message(state, vp) -> (msg, mask)``
``process_message(T,E,V,U&)``    ``process_message(state, msg, evals, vp_r)``
``reduce_function(U&, U)``       ``reduce`` — a :class:`Monoid` (or pytree of
                                 monoids / generic combine)
``apply(U, V&)``                 ``apply(state, reduced, vp) -> vp``
``operator!=``                   ``changed(old_vp, new_vp) -> bool[n]``
``do_every_iteration(int)``      ``do_every_iteration(state, vp, it, ctx)``
==============================  =============================================

Program *state* (e.g. BFS's ``current_depth``, DeltaStepping's bucket id,
LDA's ``global_N``) is an explicit pytree threaded through the jitted
iteration loop, replacing the reference's mutable members.

The whole step — send/mask, edge gather, ⊗, segment-⊕, apply, activity
diff, convergence all-reduce — traces into ONE XLA computation per program,
so an entire ``run_graph_program`` is a single compiled ``while_loop``/
``fori_loop`` on device.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax.numpy as jnp
from jax import tree_util

from .types import Activity, Direction, Monoid, SUM

__all__ = ["GraphProgram", "IterationContext"]


class IterationContext:
    """Facilities available to ``do_every_iteration``.

    On a single device the cross-device reduces are identity; under the
    sharded runtime they become ``psum``-style collectives (replacing the
    reference's MapReduce-to-rank-0-then-Bcast, ``multinode/reduce.h:54-72``).
    """

    def __init__(self, psum=None):
        self._psum = psum

    def all_reduce_sum(self, tree):
        if self._psum is None:
            return tree
        return self._psum(tree)

    def masked_vertex_sum(self, values, valid_vertex):
        """Sum an ``[n_pad, ...]`` array over valid vertices, globally."""
        def one(leaf):
            mask = valid_vertex.reshape(
                valid_vertex.shape + (1,) * (leaf.ndim - 1))
            return jnp.sum(jnp.where(mask, leaf, 0), axis=0)
        return self.all_reduce_sum(tree_util.tree_map(one, values))


class GraphProgram:
    """Base class for vertex programs.  Subclass and override.

    Class/instance attributes (static — changing them recompiles):

    * ``order``: :class:`Direction` (default OUT_EDGES, ``GraphProgram.h:52``)
    * ``activity``: :class:`Activity` (default ACTIVE_ONLY)
    * ``reduce``: the ⊕ monoid — a :class:`Monoid` or a pytree of monoids
      matching the reduced-message pytree
    * ``process_requires_vertexprop``: set False when ``process_message``
      ignores the receiver's property — skips a gather (the reference's
      SpMSpV vs SpMSpV3 selection, ``SPMV.h:67-71``)
    * ``vector_message``: True makes ⊕ a CONCAT — each receiver collects
      ALL its incoming contributions into a static-width padded row, so
      ``apply`` receives ``[n_pad, D, ...]`` (D = the direction's max
      in-degree, or ``max_message_width``) padded with ``vector_pad``.
      The static-shape form of the reference's variable-length
      ``Serializable`` messages + vector-append reduce
      (``test/test_get_neighbors.cpp:131-137``,
      ``src/TriangleCounting.cpp:92-109``); ``reduce`` is ignored.
    * ``vector_pad``: pad value for concat rows (casts per leaf).
    * ``max_message_width``: static cap on D (contributions beyond it
      drop — size it to the graph's max in-degree, the default).
    """

    order: Direction = Direction.OUT_EDGES
    activity: Activity = Activity.ACTIVE_ONLY
    reduce: Any = SUM
    process_requires_vertexprop: bool = True
    vector_message: bool = False
    vector_pad: Any = 2**31 - 1
    max_message_width: Optional[int] = None

    # -------------------------------------------------------------- hooks

    def init_state(self, graph) -> Any:
        """Initial program-state pytree (scan carry)."""
        return ()

    def send_message(self, state, vp) -> Tuple[Any, Optional[Any]]:
        """Produce the message pytree for every vertex ([n_pad] leading dim)
        and an optional boolean send mask (None = all send).

        Only entries where the vertex is active AND the mask holds reach any
        receiver — the reference's bool return from ``send_message``.
        """
        raise NotImplementedError

    def process_message(self, state, msg, edge_vals, vp_receiver) -> Any:
        """⊗: combine gathered sender messages ([e_pad] leading dim) with
        edge values (and, if ``process_requires_vertexprop``, the receiver's
        gathered properties) into reduced-message contributions."""
        raise NotImplementedError

    def apply(self, state, reduced, vp) -> Any:
        """Produce the new vertex-property pytree from the reduced messages.

        Called vectorized over all vertices; the runtime keeps the old
        property wherever no message arrived (the reference only invokes
        ``apply`` under the y bitvector, ``GraphMatRuntime.h:196-216``).
        """
        raise NotImplementedError

    def changed(self, old_vp, new_vp) -> Any:
        """Per-vertex bool: did the property change (``operator!=``)?

        Default: any leaf differs elementwise.
        """
        leaves_old = tree_util.tree_leaves(old_vp)
        leaves_new = tree_util.tree_leaves(new_vp)
        acc = None
        for o, nw in zip(leaves_old, leaves_new):
            neq = o != nw
            if neq.ndim > 1:
                neq = jnp.any(neq, axis=tuple(range(1, neq.ndim)))
            acc = neq if acc is None else (acc | neq)
        return acc

    def do_every_iteration(self, state, vp, it, ctx: IterationContext):
        """Per-iteration state update hook (``GraphProgram.h:98``).  Must be
        traceable; runs inside the compiled loop after apply."""
        return state
