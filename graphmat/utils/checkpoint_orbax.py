"""Device-sharded checkpoint via orbax (large-graph path).

The npz checkpoint (:mod:`graphmat.utils.checkpoint`) gathers vertex
state to host — fine for single-host graphs, quadratic pain at pod
scale.  This module saves the sharded arrays directly from device memory
(every host writes only its shards, in parallel) and restores them onto
any mesh: orbax re-shards on load given the target shardings.

Arrays are stored in the SOURCE graph's internal layout (padded,
possibly degree-permuted); a small sidecar (``layout.npz``) records the
vertex permutation and padded size so a restore onto a graph with a
different mesh/permutation remaps device-side through one host-built
index map.  When the layouts match (the common resume case) the restore
is a straight shard-parallel read.

Compare the reference's ``WriteGraphMatBin`` per-rank Boost archives
(``Graph.h:152-208``), which refuse to load under a different rank or
thread count — here the mesh shape AND vertex layout are properties of
the RESTORE, not the checkpoint.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["save_sharded_state", "load_sharded_state"]


def _ckptr():
    import orbax.checkpoint as ocp
    return ocp.StandardCheckpointer()


def _state_of(graph) -> dict:
    return {"vp": dict(graph.vp), "active": graph.active}


def save_sharded_state(graph, path: str) -> None:
    """Save vp pytree + active mask from device, shard-parallel."""
    path = os.path.abspath(path)
    ckptr = _ckptr()
    ckptr.save(path, _state_of(graph), force=True)
    ckptr.wait_until_finished()
    if jax.process_index() != 0:
        return   # orbax coordinates the main save; the sidecar is host-0's
    perm = getattr(graph, "perm", None)
    # temp-file + rename: a reader (or a crashed writer) must never see a
    # torn zip — the layout-aware restore depends on this file parsing
    tmp = path + ".layout.tmp.npz"   # np.savez appends .npz otherwise
    np.savez(tmp,
             n=np.int64(graph.n), n_pad=np.int64(graph.n_pad),
             perm=(np.asarray(perm, np.int64) if perm is not None
                   else np.zeros(0, np.int64)))
    os.replace(tmp, path + ".layout.npz")


def load_sharded_state(graph, path: str) -> None:
    """Restore onto ``graph`` (any mesh / any vertex permutation)."""
    path = os.path.abspath(path)
    meta_file = path + ".layout.npz"
    src_n_pad = graph.n_pad
    src_perm: Optional[np.ndarray] = None
    if os.path.exists(meta_file):
        meta = np.load(meta_file)
        src_n_pad = int(meta["n_pad"])
        src_perm = meta["perm"] if meta["perm"].size else None
    tgt_perm = getattr(graph, "perm", None)
    same_layout = src_n_pad == graph.n_pad and (
        (src_perm is None and tgt_perm is None)
        or (src_perm is not None and tgt_perm is not None
            and np.array_equal(src_perm, tgt_perm)))

    ckptr = _ckptr()
    if same_layout:
        template = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype,
                                           sharding=a.sharding)
            if hasattr(a, "sharding") else a,
            _state_of(graph))
        restored = ckptr.restore(path, template)
        graph.vp = restored["vp"]
        graph.active = restored["active"]
        return

    # layout conversion: restore in the SAVED shape (replicated on the
    # target mesh), then remap saved-internal -> target-internal slots
    # through original vertex order with one device gather
    from jax.sharding import NamedSharding, PartitionSpec
    repl = NamedSharding(graph.mesh, PartitionSpec()) \
        if getattr(graph, "mesh", None) is not None else None

    def tmpl(a):
        if not hasattr(a, "sharding"):
            return a
        shape = (src_n_pad,) + a.shape[1:]
        if repl is not None:
            return jax.ShapeDtypeStruct(shape, a.dtype, sharding=repl)
        return jax.ShapeDtypeStruct(shape, a.dtype)

    restored = ckptr.restore(path, jax.tree_util.tree_map(
        tmpl, _state_of(graph)))

    # src slot holding original vertex i: src_perm[i] (or i); target slot
    # t holds original vertex orig_of_tgt[t]
    n = graph.n
    orig_of_tgt = np.full(graph.n_pad, -1, np.int64)
    if tgt_perm is None:
        orig_of_tgt[:n] = np.arange(n)
    else:
        orig_of_tgt[tgt_perm] = np.arange(n)
    valid = orig_of_tgt >= 0
    src_of_orig = (src_perm if src_perm is not None
                   else np.arange(n, dtype=np.int64))
    src_of_tgt = np.where(valid, src_of_orig[np.maximum(orig_of_tgt, 0)
                                             % max(n, 1)], 0)
    idx = jnp.asarray(src_of_tgt, jnp.int32)
    vmask = jnp.asarray(valid)

    def remap(a, fill=0):
        out = jnp.take(a, idx, axis=0)
        m = vmask.reshape((graph.n_pad,) + (1,) * (out.ndim - 1))
        return jnp.where(m, out, jnp.zeros_like(out))

    vp = {k: remap(v) for k, v in restored["vp"].items()}
    act = remap(restored["active"])
    sh = getattr(graph, "vec_sharding", None)
    if sh is not None:
        vp = {k: jax.device_put(v, sh) for k, v in vp.items()}
        act = jax.device_put(act, sh)
    graph.vp = vp
    graph.active = act
