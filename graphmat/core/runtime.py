"""The iteration driver: ``run_graph_program`` as one compiled XLA loop.

Re-design of ``include/GraphMatRuntime.h:94-279``.  The reference's iteration:

1. clear scratch x/y
2. IntersectReduce(active, vp) -> x        (send_message under bitvector)
3. SpMSpV / SpMTSpV (column-bcast, local multiply, row-reduce over MPI)
4. apply + activity diff (bit-scan loop)
5. MPI_Allreduce(LAND) convergence
6. do_every_iteration

Here the same dataflow is a pure function ``step`` traced once and driven by
``lax.fori_loop`` (fixed iterations) or ``lax.while_loop``
(UNTIL_CONVERGENCE), so the entire run executes on device with zero host
round-trips.  The "network" phases disappear on one device and become mesh
collectives in :mod:`graphmat.parallel` on many.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax import tree_util

from ..ops.segment import (masked_fill_identity, segment_any,
                           segment_concat_tree, segment_reduce_tree)
from .graph import EdgeArrays, Graph
from .program import GraphProgram, IterationContext
from .types import Activity, Direction, UNTIL_CONVERGENCE

__all__ = ["Engine", "engine_for", "run_graph_program",
           "graph_program_init"]


def engine_for(program, graph, **kw):
    """Engine dispatch by graph type: single-device :class:`Engine` for a
    ``Graph``, :class:`~graphmat.parallel.dist_runtime.DistEngine`
    for a 2D-sharded ``DistGraph``.  Lets every app runner accept either
    (the reference's binaries are likewise mpirun-agnostic)."""
    from ..parallel.dist_graph import DistGraph
    if isinstance(graph, DistGraph):
        from ..parallel.dist_runtime import DistEngine
        return DistEngine(program, graph, **kw)
    return Engine(program, graph, **kw)


def _direction_receivers(order: Direction):
    if order == Direction.OUT_EDGES:
        return ("dst",)
    if order == Direction.IN_EDGES:
        return ("src",)
    return ("dst", "src")


def _where_tree(mask, new_tree, old_tree):
    def one(new, old):
        if new is old:
            # apply() returned the plane untouched (e.g. BFS's id
            # plane): skip the select — one fewer [n_pad] op per
            # iteration inside the convergence loop
            return old
        m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
        return jnp.where(m, new, old)
    return tree_util.tree_map(one, new_tree, old_tree)


def _combine_tree(monoid, a, b):
    from .types import Monoid
    if isinstance(monoid, Monoid):
        return tree_util.tree_map(monoid.combine, a, b)
    return tree_util.tree_map(lambda m, x, y: m.combine(x, y), monoid, a, b)


class Engine:
    """Compiled executor for one (program, graph-shape) pair.

    The analog of the reference's ``graph_program_init`` scratch structure
    (``GraphMatRuntime.h:60-76``) — here it caches jitted callables instead
    of MPI buffers.  Reuse it across runs (e.g. DeltaStepping re-enters per
    bucket) to avoid recompiles.
    """

    def __init__(self, program: GraphProgram, graph: Graph,
                 ctx: Optional[IterationContext] = None):
        self.program = program
        self.graph = graph
        self.ctx = ctx if ctx is not None else IterationContext()
        self._n_pad = graph.n_pad
        # Edge arrays flow through jit ARGUMENTS, not closure captures —
        # captured device arrays become inline constants in the compiled
        # program (hundreds of MB for big graphs).
        self._edges = {recv: graph.edges_for(recv)
                       for recv in _direction_receivers(program.order)}
        self._msg_width = {}
        if getattr(program, "vector_message", False):
            from ..ops.neighbors import max_degree
            for recv in _direction_receivers(program.order):
                self._msg_width[recv] = (program.max_message_width
                                         if program.max_message_width
                                         else max_degree(graph, recv))

        def step(carry, structure):
            it, state, vp, active, _converged = carry
            prog = self.program
            valid_vertex = structure["valid_vertex"]

            msg, send_mask = prog.send_message(state, vp)
            sent = active & valid_vertex
            if send_mask is not None:
                sent = sent & send_mask

            reduced = None
            got = None
            vecmsg = getattr(prog, "vector_message", False)
            for recv in _direction_receivers(prog.order):
                ea: EdgeArrays = structure["edges"][recv]
                x_e = tree_util.tree_map(lambda a: a[ea.senders], msg)
                e_ok = sent[ea.senders] & ea.valid
                vp_r = None
                if prog.process_requires_vertexprop:
                    vp_r = tree_util.tree_map(
                        lambda a: a[ea.receivers], vp)
                u_e = prog.process_message(state, x_e, ea.vals, vp_r)
                if vecmsg:
                    partial = segment_concat_tree(
                        u_e, e_ok, ea.receivers, self._n_pad,
                        self._msg_width[recv], prog.vector_pad)
                else:
                    u_e = masked_fill_identity(prog.reduce, u_e, e_ok)
                    partial = segment_reduce_tree(
                        prog.reduce, u_e, ea.receivers, self._n_pad)
                g = segment_any(e_ok, ea.receivers, self._n_pad)
                if reduced is None:
                    reduced, got = partial, g
                elif vecmsg:
                    # concat across directions (ALL_EDGES)
                    reduced = tree_util.tree_map(
                        lambda a, b: jnp.concatenate([a, b], axis=1),
                        reduced, partial)
                    got = got | g
                else:
                    reduced = _combine_tree(prog.reduce, reduced, partial)
                    got = got | g

            applied = prog.apply(state, reduced, vp)
            vp_new = _where_tree(got & valid_vertex, applied, vp)
            ch = prog.changed(vp, vp_new)
            ch = ch & got & valid_vertex
            converged = ~jnp.any(ch)

            state = prog.do_every_iteration(state, vp_new, it, self.ctx)

            if prog.activity == Activity.ALL_VERTICES:
                active_new = valid_vertex
            else:
                active_new = ch
            return (it + 1, state, vp_new, active_new, converged)

        def run_fixed(structure, state, vp, active, n_iters):
            def body(_i, carry):
                return step(carry, structure)
            carry0 = (jnp.int32(0), state, vp, active, jnp.bool_(False))
            return jax.lax.fori_loop(0, n_iters, body, carry0)

        def run_conv(structure, state, vp, active, max_iters):
            def cond(carry):
                it, _s, _v, _a, converged = carry
                return (~converged) & (it < max_iters)

            def body(carry):
                return step(carry, structure)
            carry0 = (jnp.int32(0), state, vp, active, jnp.bool_(False))
            return jax.lax.while_loop(cond, body, carry0)

        self._step = jax.jit(lambda structure, state, vp, active:
                             step((jnp.int32(0), state, vp, active,
                                   jnp.bool_(False)), structure))
        self._run_fixed = jax.jit(run_fixed, static_argnums=(4,))
        self._run_conv = jax.jit(run_conv)

    @property
    def vector_reduced_width(self) -> int:
        """Static width D of the ``reduced`` rows a vector-message
        program's ``apply`` receives (directions concat along axis 1)."""
        return sum(self._msg_width.values())

    def _structure(self):
        return {"edges": self._edges,
                "valid_vertex": self.graph.valid_vertex}

    def run(self, iterations: int = UNTIL_CONVERGENCE,
            max_iterations: int = 1_000_000, state: Any = None) -> int:
        """Run the program on the bound graph, updating ``graph.vp`` /
        ``graph.active`` in place.  Returns the number of iterations
        completed (the reference prints ``Completed %d iterations``).

        ``iterations <= 0`` means run until convergence
        (``GraphMatRuntime.h:266-271``).
        """
        g = self.graph
        if state is None:
            state = self.program.init_state(g)
        if self.program.activity == Activity.ALL_VERTICES:
            g.set_all_active()
        structure = self._structure()
        if iterations is not None and iterations > 0:
            it, state, vp, active, _ = self._run_fixed(
                structure, state, g.vp, g.active, int(iterations))
        else:
            it, state, vp, active, _ = self._run_conv(
                structure, state, g.vp, g.active, jnp.int32(max_iterations))
        g.vp = vp
        g.active = active
        # one batched fetch: each separate host read is a device sync
        it_val, self.final_state = jax.device_get((it, state))
        return int(it_val)

    def step_once(self, state=None):
        """Single un-looped iteration (debugging / stats)."""
        g = self.graph
        if state is None:
            state = self.program.init_state(g)
        it, state, vp, active, converged = self._step(
            self._structure(), state, g.vp, g.active)
        g.vp = vp
        g.active = active
        return state, bool(converged)


def graph_program_init(program: GraphProgram, graph: Graph) -> Engine:
    """Name-parity helper for the reference's ``graph_program_init``."""
    return Engine(program, graph)


def run_graph_program(program: GraphProgram, graph: Graph,
                      iterations: int = UNTIL_CONVERGENCE,
                      engine: Optional[Engine] = None,
                      max_iterations: int = 1_000_000) -> int:
    """Run ``program`` on ``graph``; returns iterations completed."""
    if engine is None:
        engine = Engine(program, graph)
    return engine.run(iterations=iterations, max_iterations=max_iterations)
