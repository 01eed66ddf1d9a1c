"""Breadth-first search with parent tracking (reference: ``src/BFS.cpp``).

Level-synchronous BFS: active frontier vertices whose depth equals
``current_depth - 1`` send their own id (``src/BFS.cpp:83-88``); an
unvisited receiver takes depth = current_depth and records the sender as
parent (``src/BFS.cpp:89-93``).  The reference's overwrite-reduce
(``reduce_function: a=b``) picks an arbitrary parent; we reduce with MIN so
the smallest sender id wins — depths are identical, parents deterministic.

Vertex property: ``depth`` (int32, INF sentinel), ``parent`` (int32, -1),
``id`` (int32, 1-based, set at init like ``src/BFS.cpp:113-118``).
Program state: ``current_depth`` starting at 1.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, ANY, UNTIL_CONVERGENCE

__all__ = ["BFSProgram", "run_bfs", "INF_DEPTH"]

INF_DEPTH = np.iinfo(np.int32).max  # MAX_DIST analog (src/BFS.cpp:38)


class BFSProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = ANY  # overwrite-reduce; deterministic min-id winner
    process_requires_vertexprop = False

    def init_state(self, graph):
        return jnp.int32(1)  # current_depth (src/BFS.cpp:70)

    def send_message(self, state, vp):
        current_depth = state
        return vp["id"], vp["depth"] == current_depth - 1

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        current_depth = state
        unvisited = vp["depth"] == INF_DEPTH
        out = dict(vp)
        out["depth"] = jnp.where(unvisited, current_depth, vp["depth"])
        out["parent"] = jnp.where(unvisited, reduced, vp["parent"])
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["depth"] != new_vp["depth"]  # operator!= (src/BFS.cpp:52)

    def do_every_iteration(self, state, vp, it, ctx):
        return state + 1


def init_bfs_graph(graph: Graph, source1: int) -> None:
    """Set ids, inf depths, then seed the 1-based source at depth 0."""
    ids = np.arange(1, graph.n + 1, dtype=np.int32)
    graph.init_vertexproperty(
        depth=np.int32(INF_DEPTH),
        parent=np.int32(-1),
        id=ids,
    )
    graph.set_all_inactive()
    graph.set_vertexproperty(source1, depth=0)
    graph.set_active(source1)


def run_bfs(graph: Graph, source1: int,
            iterations: int = UNTIL_CONVERGENCE):
    """Returns ``(depth[n], parent[n], niter)``; unreached depth = INF_DEPTH."""
    init_bfs_graph(graph, source1)
    eng = engine_for(BFSProgram(), graph)
    niter = eng.run(iterations=iterations)
    vp = graph.vp_numpy()
    return vp["depth"], vp["parent"], niter


def reachable_count(graph: Graph) -> int:
    """``applyReduceAllVertices(reachable_or_not)`` analog (src/BFS.cpp:100-106)."""
    return int((graph.vp_numpy()["depth"] < INF_DEPTH).sum())


# --------------------------------------------------------------- fast BFS
#
# The level-synchronous loop above takes ECCENTRICITY iterations — at
# RMAT-20 that is ~25 levels of which ~20 walk low-degree whisker chains
# with tiny frontiers, and each level sweeps every edge.  The fast path
# cuts the ITERATION COUNT instead:
#
# * Kernel-1 preprocessing (source-independent, legal under Graph500):
#   every in-degree-1 vertex v has a FORCED depth = depth(pred)+1, so a
#   weighted SHORTCUT edge (a -> v, w = chain distance) from v's nearest
#   in-degree>1 ancestor a lets one relaxation reach v the iteration
#   after a — iterations drop to ~core diameter.
#
# * One int32 key per vertex carries BOTH depth and parent:
#   ``key = depth << B | parent_internal_id``, so a plain int32 min
#   performs the lexicographic (depth, parent-id) reduce — depths exact,
#   parent = min-id tight predecessor.  The per-edge weight is added
#   onto the depth field (clamped so INF keys never wrap).  Requires
#   B + log2(max depth) <= 31.
#
# * Post-pass: shortcut winners are not real in-neighbors, but every
#   shortcut target has in-degree 1 — its parent is its unique
#   predecessor, host-precomputed.  All other parents come from real
#   edges and are valid BFS-tree parents by construction.

def build_bfs_shortcuts(e, max_rounds: int = 64):
    """Kernel-1 preprocessing: returns ``(e_aug, pred0, is_indeg1)``.

    ``e_aug`` = original edges (weight 1) + shortcut edges (a -> v,
    weight d) for in-degree-1 vertices v whose pred-chain reaches an
    anchor (in-degree != 1) within ``max_rounds`` pointer-doubling
    rounds; ``pred0`` is the 0-based unique predecessor (or -1);
    all-in-degree-1 cycles get no shortcut (the original edges still
    reach them correctly, just level by level).

    OPT-IN: on RMAT-class graphs the whisker population is small; the
    win grows with whisker-heavy inputs (road networks, web crawls with
    long chains) where pointer-doubling collapses O(chain) levels into
    one.  The classic level loop (``run_bfs``) needs no preprocessing
    and is the default; ``run_bfs_fast`` is for whisker-heavy graphs
    and the Graph500-style bench."""
    from ..io.edgelist import EdgeList
    n = max(e.m, e.n)
    src0 = np.asarray(e.src, np.int64) - 1
    dst0 = np.asarray(e.dst, np.int64) - 1
    indeg = np.bincount(dst0, minlength=n)
    ind1 = indeg == 1
    pred0 = np.full(n, -1, np.int64)
    m1 = ind1[dst0]
    pred0[dst0[m1]] = src0[m1]    # unique, so last write is THE pred

    # pointer doubling to the nearest anchor (in-deg != 1), path length
    # accumulated.  A vertex hops while its anchor is still an INTERIOR
    # (in-deg-1) vertex; pure in-deg-1 cycles never exit the interior
    # and their doubled distances blow past n, excluding them below.
    anchor = np.where(ind1, pred0, np.arange(n, dtype=np.int64))
    dist = np.where(ind1, 1, 0).astype(np.int64)
    for _ in range(max_rounds):
        interior = ind1 & ind1[anchor]
        if not interior.any():
            break
        dist = dist + np.where(interior, dist[anchor], 0)
        anchor = np.where(interior, anchor[anchor], anchor)
    ok = ind1 & ~ind1[anchor] & (dist >= 2) & (dist <= n)
    sc_src = anchor[ok]
    sc_dst = np.flatnonzero(ok)
    sc_w = dist[ok]
    aug_src = np.concatenate([src0 + 1, sc_src + 1])
    aug_dst = np.concatenate([dst0 + 1, sc_dst + 1])
    aug_val = np.concatenate([np.ones(len(src0)), sc_w.astype(np.float64)])
    e_aug = EdgeList(src=aug_src, dst=aug_dst, val=aug_val, m=n, n=n)
    return e_aug, pred0, ind1


class BFSFastProgram(GraphProgram):
    """Weighted min-plus value iteration over packed (depth, parent)
    keys — see the module comment above.  ``bits`` is the parent-id
    field width (>= ceil(log2 n_pad))."""
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = ANY
    process_requires_vertexprop = False

    def __init__(self, bits: int):
        self.bits = bits
        # keys must stay below KEY_BIAS + 2^28 (the process clamp that
        # keeps INF keys from wrapping): depth_cap = 2^(28-bits).  bits <= 21 keeps >= 128 levels of
        # headroom; larger graphs use the classic level-synchronous BFS
        assert 1 <= bits <= 21, \
            f"packed-key BFS supports n_pad < 2^21 (got bits={bits}); " \
            "use run_bfs for larger graphs"
        self.depth_cap = (1 << (28 - bits)) - 2

    def init_state(self, graph):
        return jnp.int32(0)

    def send_message(self, state, vp):
        key = vp["key"]
        # candidate for a weight-1 edge: depth+1, parent := own id
        # (KEY_BIAS rides the high bits through >>/<< untouched)
        iota = jnp.arange(key.shape[0], dtype=jnp.int32)
        cand = ((key >> self.bits) + 1 << self.bits) | iota
        return cand, None

    def process_message(self, state, msg, edge_vals, vp_r):
        # weight lands on the depth field (shortcut edges carry the
        # chain distance); only real keys (< KEY_BIAS + 2^28) are
        # shifted, so INF keys pass through unchanged
        w = edge_vals.astype(jnp.int32) - 1
        ok = (msg >= KEY_BIAS) & (msg < KEY_BIAS + (1 << 28))
        return jnp.where(ok, msg + (w << self.bits), msg)

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["key"] = jnp.minimum(vp["key"], reduced)
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["key"] != new_vp["key"]

    def do_every_iteration(self, state, vp, it, ctx):
        return state


# exceeds every valid key (KEY_BIAS + 2^28 at most)
INF_KEY = 0x7F000000
# keys live at BIAS + (depth << bits | parent): BIAS is divisible by
# 2^21 so the depth-field arithmetic never touches it
KEY_BIAS = 0x20000000


def init_bfs_fast_graph(graph: Graph, source1: int) -> None:
    graph.init_vertexproperty(key=np.int32(INF_KEY))
    graph.set_all_inactive()
    # source key: depth 0, parent = own internal id
    i = graph._idx(source1)
    vp = dict(graph.vp)
    vp["key"] = vp["key"].at[i].set(np.int32(KEY_BIAS + i))
    graph.vp = vp
    graph.set_active(source1)


def run_bfs_fast(graph: Graph, source1: int, pred0, ind1,
                 iterations: int = UNTIL_CONVERGENCE):
    """BFS via shortcut-augmented min-plus value iteration.  ``graph``
    must be built from :func:`build_bfs_shortcuts`'s ``e_aug``.
    Returns ``(depth[n], parent[n], niter)`` in ORIGINAL vertex order,
    identical depths to :func:`run_bfs` (parents are a valid, generally
    different, BFS tree)."""
    bits = max(int(np.ceil(np.log2(graph.n_pad))), 1)
    prog = BFSFastProgram(bits)
    init_bfs_fast_graph(graph, source1)
    eng = engine_for(prog, graph)
    niter = eng.run(iterations=iterations)
    key = graph.vp_numpy()["key"]            # [n], ORIGINAL order
    reached = key < INF_KEY
    kz = np.where(reached, key - KEY_BIAS, 0)
    depth = np.where(reached, kz >> bits, INF_DEPTH).astype(np.int64)
    par_int = np.where(reached, kz & ((1 << bits) - 1), 0)
    # parent field holds INTERNAL indices -> map to 1-based originals
    if graph.perm is not None:
        inv = np.zeros(graph.n_pad, np.int64)
        inv[np.asarray(graph.perm)] = np.arange(graph.n)
        par_ext = np.where(reached, inv[par_int] + 1, -1)
    else:
        par_ext = np.where(reached, par_int + 1, -1)
    # shortcut winners: the recorded parent may be the chain ANCHOR,
    # not an in-neighbor — every shortcut target has in-degree 1, so
    # its true parent is its unique predecessor
    fix = reached & ind1[: graph.n]
    par_ext = np.where(fix, pred0[: graph.n] + 1, par_ext)
    par_ext[~reached] = -1
    par_ext[source1 - 1] = -1
    return depth, par_ext.astype(np.int64), niter


def _main(argv=None):
    """CLI parity with ``src/BFS.cpp``: <A.mtx> <source 1-based>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = (argv if argv is not None else sys.argv[1:])
    if len(args) < 2:
        print("Correct format: bfs A.mtx source_vertex (1-based index)")
        return 0
    from ..core.graph import Graph
    g = build_graph(load_graph_file(args[0]), build_in_edges=False)
    t0 = time.time()
    depth, parent, niter = run_bfs(g, int(args[1]))
    print(f"Completed {niter} iterations")
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Reachable vertices = {int((depth < INF_DEPTH).sum())}")
    for i in range(min(10, g.n)):
        if depth[i] < INF_DEPTH:
            print(f"Depth {i + 1} : {depth[i]} parent: {parent[i]}")
        else:
            print(f"Depth {i + 1} : INF")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
