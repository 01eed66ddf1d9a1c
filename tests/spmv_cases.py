"""Shared cases for the one-step generalized-SpMV semantics tests.

One engine step of :class:`SemProgram` sends ``x`` (or the sender id, or
a bool) from every sending vertex, applies ⊗ per edge, reduces with ⊕ into
the receiver and marks it ``hit``.  :func:`reference_step` computes the
same with dense numpy loops over the edge list, independent of the engine.
"""

import jax.numpy as jnp
import numpy as np

from graphmat.core.program import GraphProgram
from graphmat.core.types import (ANY, LOR, MAX, MIN, SUM, Activity,
                                 Direction, Monoid)
from graphmat.io.edgelist import edgelist_from_arrays
from graphmat.utils.generators import rmat_edgelist

SENTINEL = -777.0


def _lexmax_abs(a, b):
    """Associative, commutative: the larger |v|, ties to the larger v."""
    take_a = (jnp.abs(a) > jnp.abs(b)) | ((jnp.abs(a) == jnp.abs(b))
                                           & (a >= b))
    return jnp.where(take_a, a, b)


def _lexmax_abs_np(a, b):
    return a if (abs(a), a) >= (abs(b), b) else b


GENERIC = Monoid("generic", combine_fn=_lexmax_abs, identity_fn=lambda dt: 0)

# kind -> (monoid, ⊗ with edge value, ⊗ without)
KINDS = {
    "sum": (SUM, lambda m, w: m * w, lambda m: m),
    "min": (MIN, lambda m, w: m + w, lambda m: m),
    "max": (MAX, lambda m, w: m - w, lambda m: m),
    "or": (LOR, lambda m, w: m & (w % 2 == 1), lambda m: m),
    "any": (ANY, None, lambda m: m),
    "generic": (GENERIC, lambda m, w: m * w - 3, lambda m: m - 3),
}


class SemProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    process_requires_vertexprop = False

    def __init__(self, kind, use_ev):
        self.kind = kind
        self.reduce = KINDS[kind][0]
        self.use_ev = use_ev and KINDS[kind][1] is not None

    def send_message(self, state, vp):
        if self.kind == "or":
            return vp["x"] > 0, None
        if self.kind == "any":
            return vp["id"], None
        return vp["x"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        _m, with_ev, without = KINDS[self.kind]
        if not self.use_ev:
            return without(msg)
        w = edge_vals.astype(jnp.int32)
        return with_ev(msg, w if self.kind == "or" else
                       w.astype(msg.dtype))

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["y"] = reduced.astype(jnp.float32)
        out["hit"] = jnp.ones_like(vp["hit"])
        return out


GRAPHS = ("empty", "single", "hub_sender", "hot_receiver", "n1", "n127",
          "n129", "uniform", "rmat8")


def make_graph(name):
    """1-based EdgeList with int32 weights in [1, 5]."""
    rng = np.random.default_rng(GRAPHS.index(name))
    if name == "empty":
        n, s, d = 5, np.zeros(0, int), np.zeros(0, int)
    elif name == "single":
        n, s, d = 4, np.array([2]), np.array([3])
    elif name == "hub_sender":
        n = 64
        s = np.r_[np.ones(n - 1, int), rng.integers(1, n + 1, 20)]
        d = np.r_[np.arange(2, n + 1), rng.integers(1, n + 1, 20)]
    elif name == "hot_receiver":
        n = 64
        s = np.r_[np.arange(1, n + 1), rng.integers(1, n + 1, 20)]
        d = np.r_[np.full(n, 6), rng.integers(1, n + 1, 20)]
    elif name == "n1":
        n, s, d = 1, np.array([1]), np.array([1])
    elif name in ("n127", "n129", "uniform"):
        n = {"n127": 127, "n129": 129, "uniform": 200}[name]
        s = rng.integers(1, n + 1, 4 * n)
        d = rng.integers(1, n + 1, 4 * n)
    else:
        e = rmat_edgelist(8, 8, seed=3)
        n, s, d = e.m, e.src, e.dst
    w = rng.integers(1, 6, len(s)).astype(np.int32)
    return edgelist_from_arrays(s, d, w, m=n, n=n)


def make_frontier(name, n):
    if name == "dense":
        return np.ones(n, bool)
    if name == "empty":
        return np.zeros(n, bool)
    f = np.zeros(n, bool)
    f[::7] = True
    return f


def init_vp(graph, n):
    rng = np.random.default_rng(n)
    x = rng.integers(-8, 9, n).astype(np.float32)
    graph.init_vertexproperty(x=x, id=np.arange(1, n + 1, dtype=np.int32),
                              y=np.float32(SENTINEL), hit=False)
    return x


def reference_step(e, x, frontier, kind, use_ev):
    """(y, hit) over the n vertices: dense numpy, edge by edge."""
    n = e.m
    prog_ev = use_ev and KINDS[kind][1] is not None
    y = np.full(n, SENTINEL)
    hit = np.zeros(n, bool)
    acc = {}
    for s, d, w in zip(e.src - 1, e.dst - 1, e.val):
        if not frontier[s]:
            continue
        if kind == "or":
            m = x[s] > 0
            c = bool(m & (w % 2 == 1)) if prog_ev else bool(m)
        elif kind == "any":
            c = s + 1
        elif prog_ev:
            c = {"sum": x[s] * w, "min": x[s] + w, "max": x[s] - w,
                 "generic": x[s] * w - 3}[kind]
        else:
            c = x[s] - 3 if kind == "generic" else x[s]
        if d not in acc:
            acc[d] = c
        elif kind == "sum":
            acc[d] = acc[d] + c
        elif kind in ("min", "any"):
            acc[d] = min(acc[d], c)
        elif kind == "max":
            acc[d] = max(acc[d], c)
        elif kind == "or":
            acc[d] = acc[d] or c
        else:
            acc[d] = _lexmax_abs_np(acc[d], c)
    for d, c in acc.items():
        y[d] = float(c)
        hit[d] = True
    return y, hit


def cases():
    """(kind, graph, frontier, use_ev), pruned to cases that differ:
    every ⊕ on every graph with a sparse frontier and edge values; the
    dense and empty frontiers on RMAT; edge values off on a uniform
    graph (for the ⊕ whose ⊗ reads them)."""
    out = [(k, g, "sparse", True) for k in KINDS for g in GRAPHS]
    out += [(k, "rmat8", f, True) for k in KINDS for f in ("dense",
                                                            "empty")]
    out += [(k, "uniform", "dense", False) for k in KINDS if k != "any"]
    return out
