"""The 2D-sharded iteration driver: shard_map + mesh collectives.

XLA replacement for the reference's hand-rolled MPI exchange in
``multinode/spmspv.h:41-206`` / ``spmspv3.h:41-267``:

==========================================  ===================================
reference (MPI point-to-point)               here (XLA collectives)
==========================================  ===================================
column broadcast of x segments               ``all_gather(msg, 'r')``
  (compress → Isend nnz → Isend payload)       (fixed-size, bf16/f32 tiles)
row broadcast of vertexprop (SpMSpV3)        ``all_gather(vp, 'c')``
row reduction of y partials + union_received ``psum_scatter('c')`` for ⊕ = sum,
  (queued buffers, user add_fp)                ``all_to_all('c')`` + local ⊕
                                               for min/max/generic
MPI_Allreduce(LAND) convergence              ``psum`` of changed-count
==========================================  ===================================

The whole per-iteration dataflow — send, gather, ⊗, local segment-⊕,
reduce-scatter, apply, convergence psum, the do_every_iteration hook — is
one ``shard_map``-ped function wrapped in ``lax.while_loop`` /
``fori_loop``, so a full multi-device run is a single XLA program.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, tree_util
from jax.sharding import PartitionSpec as P

from ..core.program import GraphProgram, IterationContext
from ..core.types import Activity, Direction, Monoid, UNTIL_CONVERGENCE
from ..ops.segment import (masked_fill_identity, segment_any,
                           segment_reduce_tree)
from .dist_graph import DistEdgeTiles, DistGraph
from .mesh import COL_AXIS, ROW_AXIS

__all__ = ["DistEngine", "run_graph_program_dist"]


def _direction_receivers(order: Direction):
    if order == Direction.OUT_EDGES:
        return ("dst",)
    if order == Direction.IN_EDGES:
        return ("src",)
    return ("dst", "src")


def _where_tree(mask, new_tree, old_tree):
    def one(new, old):
        m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
        return jnp.where(m, new, old)
    return tree_util.tree_map(one, new_tree, old_tree)


def _combine_tree(monoid, a, b):
    if isinstance(monoid, Monoid):
        return tree_util.tree_map(monoid.combine, a, b)
    return tree_util.tree_map(lambda m, x, y: m.combine(x, y), monoid, a, b)


def _reduce_scatter_monoid(monoid, tree, axis, num_chunks):
    """Reduce partials across ``axis`` and keep this device's chunk.

    ⊕ = sum rides the wire-efficient ``psum_scatter``; other monoids do an
    ``all_to_all`` exchange (same bytes on the wire) and combine locally —
    the analog of the reference's ``union_received`` with a user add_fp
    (``DenseSegment.h:808-830``).
    """
    def one(m: Monoid, leaf):
        if m.kind == "sum":
            return lax.psum_scatter(leaf, axis, scatter_dimension=0,
                                    tiled=True)
        exchanged = lax.all_to_all(leaf, axis, split_axis=0, concat_axis=0,
                                   tiled=True)
        chunks = exchanged.reshape((num_chunks, -1) + leaf.shape[1:])
        out = chunks[0]
        for i in range(1, num_chunks):
            out = m.combine(out, chunks[i])
        return out

    if isinstance(monoid, Monoid):
        return tree_util.tree_map(lambda leaf: one(monoid, leaf), tree)
    return tree_util.tree_map(one, monoid, tree)


class DistEngine:
    """Compiled 2D-sharded executor for one (program, DistGraph) pair."""

    def __init__(self, program: GraphProgram, graph: DistGraph):
        self.program = program
        self.graph = graph
        mesh = graph.mesh
        R, C, S = graph.R, graph.C, graph.S
        self.ctx = IterationContext(
            psum=lambda t: lax.psum(t, (ROW_AXIS, COL_AXIS)))

        tiles = {r: graph.tiles_for(r)
                 for r in _direction_receivers(program.order)}
        n_row_local = C * S  # receivers per row block
        # concat-reduce widths: same static width on every device, so the
        # per-tile width is the max over ALL tiles
        self._msg_width = {}
        if getattr(program, "vector_message", False):
            for recv in _direction_receivers(program.order):
                if program.max_message_width:
                    w = program.max_message_width
                else:
                    w = 1
                    for (_s, r_loc, _v) in graph._host_tiles[recv]:
                        if len(r_loc):
                            w = max(w, int(np.bincount(r_loc).max()))
                self._msg_width[recv] = w

        def xla_partials(state, vp_row, msg_col, sent_col, structure):
            prog = self.program
            vecmsg = getattr(prog, "vector_message", False)
            reduced = None
            got = None
            for recv in _direction_receivers(prog.order):
                ea: DistEdgeTiles = structure["tiles"][recv]
                senders = ea.senders[0]
                receivers = ea.receivers[0]
                vals = ea.vals[0]
                valid = ea.valid[0]
                x_e = tree_util.tree_map(lambda a: a[senders], msg_col)
                e_ok = sent_col[senders] & valid
                vp_r = None
                if prog.process_requires_vertexprop:
                    vp_r = tree_util.tree_map(lambda a: a[receivers], vp_row)
                u_e = prog.process_message(state, x_e, vals, vp_r)
                if vecmsg:
                    from ..ops.segment import segment_concat_tree
                    partial = segment_concat_tree(
                        u_e, e_ok, receivers, n_row_local,
                        self._msg_width[recv], prog.vector_pad)
                else:
                    u_e = masked_fill_identity(prog.reduce, u_e, e_ok)
                    partial = segment_reduce_tree(prog.reduce, u_e,
                                                  receivers, n_row_local)
                g = segment_any(e_ok, receivers, n_row_local)
                if reduced is None:
                    reduced, got = partial, g
                elif vecmsg:
                    reduced = tree_util.tree_map(
                        lambda a, b: jnp.concatenate([a, b], axis=1),
                        reduced, partial)
                    got = got | g
                else:
                    reduced = _combine_tree(prog.reduce, reduced, partial)
                    got = got | g
            if vecmsg:
                # CONCAT across the column axis = the SERIALIZED wire
                # format's list merge (DenseSegment.h:808-830): one
                # all_to_all splits rows back to their owners while
                # concatenating each receiver's per-shard lists
                reduced = tree_util.tree_map(
                    lambda leaf: lax.all_to_all(
                        leaf, COL_AXIS, split_axis=0, concat_axis=1,
                        tiled=True), reduced)
            else:
                # fold partials across the column axis; keep this segment
                reduced = _reduce_scatter_monoid(prog.reduce, reduced,
                                                 COL_AXIS, C)
            got = lax.psum_scatter(got.astype(jnp.int32), COL_AXIS,
                                   scatter_dimension=0, tiled=True) > 0
            return reduced, got

        def local_step(carry, structure):
            """Body on ONE device: local shards + explicit collectives."""
            it, state, vp, active, _conv = carry
            prog = self.program
            valid_vertex = structure["valid_vertex"]  # [S]

            msg, send_mask = prog.send_message(state, vp)
            sent = active & valid_vertex
            if send_mask is not None:
                sent = sent & send_mask

            # column broadcast down the row axis
            msg_col, sent_col = lax.all_gather((msg, sent), ROW_AXIS,
                                               tiled=True)
            vp_row = None
            if prog.process_requires_vertexprop:
                vp_row = lax.all_gather(vp, COL_AXIS, tiled=True)
            reduced, got = xla_partials(state, vp_row, msg_col,
                                        sent_col, structure)

            applied = prog.apply(state, reduced, vp)
            vp_new = _where_tree(got & valid_vertex, applied, vp)
            ch = prog.changed(vp, vp_new) & got & valid_vertex
            nchanged = lax.psum(jnp.sum(ch.astype(jnp.int32)),
                                (ROW_AXIS, COL_AXIS))
            converged = nchanged == 0

            state = prog.do_every_iteration(state, vp_new, it, self.ctx)

            if prog.activity == Activity.ALL_VERTICES:
                active_new = valid_vertex
            else:
                active_new = ch
            return (it + 1, state, vp_new, active_new, converged)

        tile_spec = DistEdgeTiles(*([P((ROW_AXIS, COL_AXIS))] * 4))
        structure_specs = {
            "valid_vertex": P((ROW_AXIS, COL_AXIS)),
            "tiles": {r: tile_spec for r in tiles},
        }
        vp_spec = P((ROW_AXIS, COL_AXIS))

        def run_fixed(structure, state, vp, active, n_iters):
            def body(_i, carry):
                return local_step(carry, structure)
            carry0 = (jnp.int32(0), state, vp, active, jnp.bool_(False))
            return lax.fori_loop(0, n_iters, body, carry0)

        def run_conv(structure, state, vp, active, max_iters):
            def cond(carry):
                it, _s, _v, _a, converged = carry
                return (~converged) & (it < max_iters)

            def body(carry):
                return local_step(carry, structure)
            carry0 = (jnp.int32(0), state, vp, active, jnp.bool_(False))
            return lax.while_loop(cond, body, carry0)

        def spec_like(tree, spec):
            return tree_util.tree_map(lambda _: spec, tree)

        def shmapped(runner, structure, state, vp, active, extra):
            in_specs = (structure_specs,
                        spec_like(state, P()),
                        spec_like(vp, vp_spec),
                        P((ROW_AXIS, COL_AXIS)),
                        P())
            out_specs = (P(), spec_like(state, P()), spec_like(vp, vp_spec),
                         P((ROW_AXIS, COL_AXIS)), P())
            f = jax.shard_map(runner, mesh=mesh,
                              in_specs=in_specs, out_specs=out_specs,
                              check_vma=False)
            return f(structure, state, vp, active, extra)

        self._run_fixed = jax.jit(
            lambda structure, state, vp, active, n:
            shmapped(lambda s, st, v, a, nn: run_fixed(s, st, v, a, nn),
                     structure, state, vp, active, n),
            static_argnums=(4,))
        self._run_conv = jax.jit(
            lambda structure, state, vp, active, mx:
            shmapped(run_conv, structure, state, vp, active, mx))

        self._structure = {"valid_vertex": graph.valid_vertex,
                           "tiles": tiles}

    @property
    def vector_reduced_width(self) -> int:
        """Static width of a vector-message program's ``reduced`` rows:
        per-shard widths concat across directions, then across the C
        column shards in the all_to_all merge."""
        return self.graph.C * sum(self._msg_width.values())

    def run(self, iterations: int = UNTIL_CONVERGENCE,
            max_iterations: int = 1_000_000, state: Any = None) -> int:
        g = self.graph
        if state is None:
            state = self.program.init_state(g)
        if self.program.activity == Activity.ALL_VERTICES:
            g.set_all_active()
        if iterations is not None and iterations > 0:
            it, state, vp, active, _ = self._run_fixed(
                self._structure, state, g.vp, g.active, int(iterations))
        else:
            it, state, vp, active, _ = self._run_conv(
                self._structure, state, g.vp, g.active,
                jnp.int32(max_iterations))
        g.vp = vp
        g.active = active
        it_val, self.final_state = jax.device_get((it, state))
        return int(it_val)


def run_graph_program_dist(program: GraphProgram, graph: DistGraph,
                           iterations: int = UNTIL_CONVERGENCE,
                           engine: Optional[DistEngine] = None,
                           max_iterations: int = 1_000_000) -> int:
    if engine is None:
        engine = DistEngine(program, graph)
    return engine.run(iterations=iterations, max_iterations=max_iterations)
