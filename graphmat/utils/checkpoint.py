"""Checkpoint / resume.

The reference checkpoints graph structure as per-rank Boost binary archives
(``WriteGraphMatBin``/``ReadGraphMatBin``, ``Graph.h:152-208``) that REFUSE
to load under a different rank or thread count.  This design is
sharding-agnostic: one npz holds the canonical edge list + dims, and vertex
state (property pytree + active mask) saves independently of mesh shape, so
a checkpoint taken on one mesh restores onto any other.

Also provides ``save_vertexproperty`` text export
(``Graph::saveVertexproperty``, ``Graph.h:338-350``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..io.edgelist import EdgeList

__all__ = [
    "save_edgelist_checkpoint",
    "load_edgelist_checkpoint",
    "save_graph_state",
    "load_graph_state",
    "save_vertexproperty",
]

_MAGIC = "graphmat-ckpt-v1"


def save_edgelist_checkpoint(e: EdgeList, path: str) -> None:
    """Graph-structure checkpoint (GraphMatBin analog, rank-agnostic)."""
    np.savez_compressed(path if path.endswith(".npz") else path + ".npz",
                        magic=_MAGIC, m=e.m, n=e.n, src=e.src, dst=e.dst,
                        val=e.val)


def load_edgelist_checkpoint(path: str) -> EdgeList:
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    assert str(z["magic"]) == _MAGIC, "not a graphmat checkpoint"
    return EdgeList(int(z["m"]), int(z["n"]), z["src"], z["dst"], z["val"])


def save_graph_state(graph, path: str) -> None:
    """Vertex state checkpoint: property pytree + active mask.

    Works for both :class:`core.graph.Graph` and
    :class:`parallel.dist_graph.DistGraph` (arrays are pulled to host in
    original vertex order, so mesh shape does not matter).
    """
    vp = graph.vp_numpy()
    fetch = getattr(graph, "_fetch", np.asarray)  # multi-process safe
    active = np.asarray(fetch(graph.active))
    if getattr(graph, "perm", None) is not None:
        active = active[graph.perm]
    else:
        active = active[: graph.n]
    payload = {"magic": _MAGIC, "n": graph.n, "active": active}
    for k, v in vp.items():
        payload[f"vp_{k}"] = v
    np.savez_compressed(path if path.endswith(".npz") else path + ".npz",
                        **payload)


def load_graph_state(graph, path: str) -> None:
    """Restore vertex state saved by :func:`save_graph_state` onto a graph
    of the same vertex count (any mesh / padding)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    assert str(z["magic"]) == _MAGIC
    n = int(z["n"])
    if n != graph.n:
        raise ValueError(f"checkpoint has {n} vertices, graph has {graph.n}")
    fields: Dict[str, np.ndarray] = {
        k[3:]: z[k] for k in z.files if k.startswith("vp_")}
    graph.init_vertexproperty(**fields)
    # one vectorized device_put — a per-index .at[i].set loop costs a full
    # device round-trip per frontier vertex
    graph.set_active_mask(z["active"].astype(bool))


def save_vertexproperty(graph, path: str, field: str,
                        fmt: str = "%d %s") -> None:
    """Text export '1-based-id value' per line (``saveVertexproperty``)."""
    vp = graph.vp_numpy()[field]
    with open(path, "w") as f:
        for i, v in enumerate(vp, start=1):
            if np.ndim(v) > 0:
                v = " ".join(str(x) for x in np.ravel(v))
            f.write(f"{i} {v}\n")
