"""The Graph object: static-shape, device-resident graph structure + state.

JAX re-design of ``include/Graph.h:58-107``.  The reference stores the
adjacency twice (``A`` and ``AT``, ``Graph.h:68-69``) as 2D MPI-tiled DCSC
tiles; here the single-device graph keeps two *receiver-sorted edge arrays*:

* ``out_edges``  — receiver = dst (used by ``Direction.OUT_EDGES``; the
  analog of the SpMTSpV/AT path, ``GraphMatRuntime.h:160-167``),
* ``in_edges``   — receiver = src (the SpMSpV/A path).

Each is a struct-of-arrays (senders, receivers, values, valid-mask) padded to
a static shape so every iteration compiles once and runs fully on device.
Vertex properties are a pytree (dict) of ``[n_pad]`` arrays (struct-of-arrays
— the vectorizable layout for what the reference holds as an
``SpVec<DenseSegment<V>>`` array-of-structs), and the active frontier is a
dense boolean mask (the analog of the reference's bitvector,
``GMDP/utils/bitvector.h``).

Vertex ids are 1-based in the public API (file formats and the reference's
``get/setVertexproperty``, ``Graph.h:307-350``) and 0-based internally.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io.edgelist import EdgeList, edgelist_from_arrays

__all__ = ["Graph", "EdgeArrays", "round_up"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclass
class EdgeArrays:
    """Receiver-sorted COO edge arrays with static padding.

    Padding entries point at the last (padding) vertex and are masked out by
    ``valid`` — they contribute monoid identities and never set
    ``got_message``.
    """

    senders: Any    # int32[e_pad]
    receivers: Any  # int32[e_pad], sorted ascending
    vals: Any       # W[e_pad]
    valid: Any      # bool[e_pad]

    def tree_flatten(self):
        return (self.senders, self.receivers, self.vals, self.valid), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def e_pad(self) -> int:
        return self.senders.shape[0]


def _build_edge_arrays(senders0, receivers0, vals, n_pad, e_pad) -> EdgeArrays:
    """Sort 0-based COO by (receiver, sender) and pad to ``e_pad``."""
    order = np.lexsort((senders0, receivers0))
    s = senders0[order]
    r = receivers0[order]
    v = vals[order]
    nnz = s.shape[0]
    pad = e_pad - nnz
    s = np.concatenate([s, np.full(pad, n_pad - 1, np.int32)])
    r = np.concatenate([r, np.full(pad, n_pad - 1, np.int32)])
    v = np.concatenate([v, np.zeros(pad, v.dtype)])
    valid = np.zeros(e_pad, bool)
    valid[:nnz] = True
    return EdgeArrays(jnp.asarray(s), jnp.asarray(r), jnp.asarray(v),
                      jnp.asarray(valid))


class _VpRef:
    """Shared holder so two graphs can alias one vertex-property pytree
    (``Graph::shareVertexProperty``, ``Graph.h:301-305`` — used by
    DeltaStepping's light/heavy graph split)."""

    __slots__ = ("vp",)

    def __init__(self, vp):
        self.vp = vp


class Graph:
    """A static-shape device graph.

    Parameters
    ----------
    edgelist : EdgeList
        1-based COO edges.  The graph is squared to
        ``nvertices = max(m, n)`` like ``Graph::ReadMTX`` (``Graph.h:253-257``).
    build_in_edges : bool
        Whether to build the ``in_edges`` (receiver = src) ordering.  The
        reference always stores both A and AT; skip for OUT_EDGES-only
        programs to halve memory.
    n_align : int
        Vertex-count padding multiple.
    """

    def __init__(self, edgelist: EdgeList, build_in_edges: bool = True,
                 build_out_edges: bool = True, n_align: int = 128,
                 e_align: int = 1024, permute=False):
        n = max(edgelist.m, edgelist.n)
        self.n = n
        self.nnz = edgelist.nnz
        # padding edges are masked everywhere (valid=False), so no
        # dedicated pad vertex is needed — keep n_pad tight
        self.n_pad = max(round_up(n, n_align), n_align)
        self.e_pad = max(round_up(max(edgelist.nnz, 1), e_align), e_align)
        self.edge_dtype = edgelist.val.dtype

        src0 = edgelist.src.astype(np.int32) - 1
        dst0 = edgelist.dst.astype(np.int32) - 1
        vals = np.asarray(edgelist.val)

        # Internal vertex relabeling — the reference's vertexToNative
        # permutation (Graph.h:112-150) served intra-tile load balance; here
        # permute='degree' clusters high-out-degree senders at low ids, so
        # the hubs' message gathers hit a few contiguous cache lines.
        # permute may also be an explicit [n] permutation
        # (perm[original0] = internal0) or True for a seeded random one.
        self.perm = None
        if permute is not False and permute is not None and n > 0:
            if isinstance(permute, np.ndarray):
                self.perm = permute.astype(np.int64)
            elif permute == "degree":
                deg = np.bincount(src0, minlength=n)
                order = np.argsort(-deg, kind="stable")
                self.perm = np.empty(n, np.int64)
                self.perm[order] = np.arange(n)
            else:
                rng = np.random.default_rng(5)
                self.perm = rng.permutation(n).astype(np.int64)
            src0 = self.perm[src0].astype(np.int32)
            dst0 = self.perm[dst0].astype(np.int32)

        # host copies kept for building the edge arrays lazily (each
        # receiver ordering is only materialized on first use)
        self._host_edges = {}
        self._edge_arrays = {}
        if build_out_edges:
            self._host_edges["dst"] = (src0.copy(), dst0.copy(), vals.copy())
        if build_in_edges:
            self._host_edges["src"] = (dst0.copy(), src0.copy(), vals.copy())

        vv = np.zeros(self.n_pad, bool)
        vv[:n] = True
        self.valid_vertex = jnp.asarray(vv)

        self._vpref = _VpRef({})
        self.active = jnp.zeros(self.n_pad, bool)

    # ------------------------------------------------------------------ vp

    @property
    def vp(self) -> Dict[str, jnp.ndarray]:
        return self._vpref.vp

    @vp.setter
    def vp(self, value) -> None:
        self._vpref.vp = value

    def init_vertexproperty(self, **fields) -> None:
        """Initialize the vertex-property pytree.

        Each field is either a scalar (broadcast, like ``SpVec::setAll``) or
        an array of length ``n`` in ORIGINAL vertex order (padded to
        ``n_pad``; internally permuted when the graph is relabeled).
        """
        vp = {}
        for name, value in fields.items():
            arr = np.asarray(value)
            if arr.ndim == 0 or (arr.ndim >= 1 and arr.shape[0] != self.n):
                # scalar (possibly with trailing feature dims) -> broadcast
                full = np.broadcast_to(arr, (self.n_pad,) + arr.shape).copy()
            else:
                full = np.zeros((self.n_pad,) + arr.shape[1:], arr.dtype)
                if self.perm is None:
                    full[: self.n] = arr
                else:
                    full[self.perm] = arr
            vp[name] = jnp.asarray(full)
        self.vp = vp

    def set_all_vertexproperty(self, **fields) -> None:
        self.init_vertexproperty(**fields)

    def share_vertex_property(self, other: "Graph") -> None:
        """Alias this graph's vertex properties to ``other``'s
        (``Graph.h:301-305``)."""
        if other.n_pad != self.n_pad:
            raise ValueError("shareVertexProperty requires matching padded size")
        same_perm = ((self.perm is None and other.perm is None)
                     or (self.perm is not None and other.perm is not None
                         and np.array_equal(self.perm, other.perm)))
        if not same_perm:
            # two permute="degree" graphs over different edge subsets
            # (e.g. DeltaStepping's light/heavy split) derive different
            # permutations — sharing would silently misalign properties
            raise ValueError(
                "shareVertexProperty requires the same vertex permutation "
                "on both graphs; build the second graph with "
                "permute=first.perm (or permute=False on both)")
        self._vpref = other._vpref

    def _idx(self, vid1: int) -> int:
        i = vid1 - 1
        return int(self.perm[i]) if self.perm is not None else i

    def get_vertexproperty(self, vid1: int) -> Dict[str, Any]:
        """Fetch one vertex's property dict (1-based id)."""
        i = self._idx(vid1)
        return {k: np.asarray(v[i]) for k, v in self.vp.items()}

    def set_vertexproperty(self, vid1: int, **fields) -> None:
        i = self._idx(vid1)
        vp = dict(self.vp)
        for k, val in fields.items():
            vp[k] = vp[k].at[i].set(val)
        self.vp = vp

    def vp_numpy(self) -> Dict[str, np.ndarray]:
        """Host copies of the vertex-property arrays in ORIGINAL order."""
        if self.perm is None:
            return {k: np.asarray(v[: self.n]) for k, v in self.vp.items()}
        return {k: np.asarray(v)[self.perm] for k, v in self.vp.items()}

    # -------------------------------------------------------------- active

    def set_all_active(self) -> None:
        self.active = self.valid_vertex

    def set_all_inactive(self) -> None:
        self.active = jnp.zeros(self.n_pad, bool)

    def set_active(self, vid1: int) -> None:
        self.active = self.active.at[self._idx(vid1)].set(True)

    def set_active_mask(self, mask) -> None:
        """Bulk-set the frontier from a bool[n] mask in ORIGINAL vertex
        order — one device_put, not O(frontier) dispatches (the reference
        restore is likewise a bulk read, ``Graph.h:152-208``)."""
        mask = np.asarray(mask, bool)
        if mask.shape[0] != self.n:
            raise ValueError(f"mask has {mask.shape[0]} entries, "
                             f"graph has {self.n} vertices")
        full = np.zeros(self.n_pad, bool)
        if self.perm is None:
            full[: self.n] = mask
        else:
            full[self.perm] = mask
        self.active = jnp.asarray(full)

    def set_inactive(self, vid1: int) -> None:
        self.active = self.active.at[self._idx(vid1)].set(False)

    # ------------------------------------------------------------- queries

    @property
    def nvertices(self) -> int:
        return self.n

    def get_edges(self) -> EdgeList:
        """Export back to a 1-based EdgeList (``SpMat::get_edges`` analog)."""
        ea = (self.out_edges if "dst" in self._host_edges else self.in_edges)
        valid = np.asarray(ea.valid)
        s = np.asarray(ea.senders)[valid]
        r = np.asarray(ea.receivers)[valid]
        v = np.asarray(ea.vals)[valid]
        if ea is self.out_edges:
            src, dst = s, r
        else:
            src, dst = r, s
        if self.perm is not None:
            inv = np.empty(self.n, np.int64)
            inv[self.perm] = np.arange(self.n)
            src = inv[src]
            dst = inv[dst]
        return edgelist_from_arrays(src + 1, dst + 1, v, m=self.n, n=self.n)

    def edges_for(self, direction_receiver: str) -> EdgeArrays:
        """Edge arrays with the given receiver role ('dst' or 'src');
        built lazily on first use."""
        if direction_receiver not in self._host_edges:
            raise ValueError(
                f"graph was built without the receiver={direction_receiver} "
                f"ordering; pass build_{'out' if direction_receiver == 'dst' else 'in'}_edges=True")
        if direction_receiver not in self._edge_arrays:
            s0, r0, v = self._host_edges[direction_receiver]
            self._edge_arrays[direction_receiver] = _build_edge_arrays(
                s0, r0, v, self.n_pad, self.e_pad)
        return self._edge_arrays[direction_receiver]

    @property
    def out_edges(self) -> Optional[EdgeArrays]:
        return (self.edges_for("dst") if "dst" in self._host_edges else None)

    @property
    def in_edges(self) -> Optional[EdgeArrays]:
        return (self.edges_for("src") if "src" in self._host_edges else None)

    def structure_pytree(self):
        """All structure arrays as a pytree (to pass into jitted runs)."""
        return {
            "out": self.out_edges,
            "in": self.in_edges,
            "valid_vertex": self.valid_vertex,
        }

    def __repr__(self):
        return (f"Graph(n={self.n}, nnz={self.nnz}, n_pad={self.n_pad}, "
                f"e_pad={self.e_pad})")
