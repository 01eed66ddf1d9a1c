"""Multi-host execution support.

The reference scales across nodes with ``mpirun`` + hand-rolled MPI; the
JAX equivalent is ``jax.distributed`` + a mesh spanning the hosts:

* every host calls :func:`initialize` (coordinator address via env or args);
* the mesh is laid out so the **row axis spans hosts** (each host owns
  whole tile-rows) and the column axis stays inside a host — the
  per-iteration ``psum_scatter('c')`` row-reduction then stays on the
  host's NVLink while only the smaller ``all_gather('r')`` frontier
  broadcast crosses the host network;
* edge ingest is file-sharded like the reference's rank-strided
  ``load_edgelist`` (``edgelist.h:250-274``): host h reads shards
  ``prefix{h, h+nhosts, ...}`` and feeds them to the shared
  :class:`~graphmat.parallel.dist_graph.DistGraph` build, which
  device_puts only the tiles this host's devices own (jax moves the rest).

Single-process multi-device (one host, N GPUs) needs none of this —
``make_mesh()`` over ``jax.devices()`` suffices.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from ..io.edgelist import EdgeList, load_edgelist
from .mesh import make_mesh

__all__ = ["initialize", "hosts_mesh", "load_edgelist_sharded",
           "allgather_edgelist"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed (idempotent).  Arguments default to the
    cluster environment JAX detects (JAX_COORDINATOR_ADDRESS etc.)."""
    if jax.process_count() > 1:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # single-process runs (tests, one host) land here
        pass


def hosts_mesh(rows_per_host: int | None = None):
    """An ('r','c') mesh whose row axis spans hosts.

    With H hosts × D local devices: shape (H * rows_per_host,
    D // rows_per_host); default rows_per_host=1 puts one tile-row per host
    so the column ('c') reduction stays on-host and only the row ('r')
    gather crosses the host network.
    """
    nproc = jax.process_count()
    total = len(jax.devices())
    local = total // max(nproc, 1)
    if rows_per_host is None:
        rows_per_host = 1
    r = nproc * rows_per_host
    c = total // r
    if r * c != total:
        raise ValueError(f"cannot form mesh: {total} devices, R={r}")
    # order devices host-major so row blocks align with hosts
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return make_mesh(devs, (r, c))


def allgather_edgelist(e: EdgeList) -> EdgeList:
    """Union of every host's partial edge list (identical on all hosts).

    The reference shuffles loaded edges to their owner ranks with
    Isend/Irecv (``SpMat.h:171-217``); here each host contributes its
    partial list and receives the union, then the shared DistGraph build
    device_puts only the tiles this host's devices own.  One collective,
    host-memory bound like the reference's shuffle buffers.
    """
    if jax.process_count() <= 1:
        return e
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    def ag(a):
        return np.asarray(multihost_utils.process_allgather(
            jnp.asarray(a)))

    meta = ag(np.array([e.nnz, e.m, e.n], np.int64))   # [H, 3]
    mlen = int(meta[:, 0].max())

    def pad(a, dtype):
        a = np.asarray(a, dtype)
        return np.concatenate([a, np.zeros(mlen - len(a), dtype)])

    ids = ag(np.stack([pad(e.src, np.int64),
                       pad(e.dst, np.int64)]))         # [H, 2, mlen]
    vals = ag(pad(e.val, np.float64))                  # [H, mlen]
    keep = np.concatenate([np.r_[np.ones(c, bool),
                                 np.zeros(mlen - c, bool)]
                           for c in meta[:, 0]])
    vdt = np.asarray(e.val).dtype
    return EdgeList(int(meta[:, 1].max()), int(meta[:, 2].max()),
                    ids[:, 0, :].reshape(-1)[keep].astype(np.int32),
                    ids[:, 1, :].reshape(-1)[keep].astype(np.int32),
                    vals.reshape(-1)[keep].astype(vdt))


def load_edgelist_sharded(prefix: str, **kw) -> EdgeList:
    """Host-strided shard loading: host h reads ``prefix{h, h+H, ...}``.

    Mirrors ``load_edgelist``'s rank striding (``edgelist.h:250-274``).
    Follow with :func:`allgather_edgelist` to exchange partial lists
    before the DistGraph build (the Isend/Irecv shuffle analog).
    """
    h = jax.process_index()
    nh = max(jax.process_count(), 1)
    import glob as _glob
    import re as _re
    shards = []
    for p in _glob.glob(_glob.escape(prefix) + "*"):
        suffix = p[len(prefix):]
        if _re.fullmatch(r"\d+", suffix):
            shards.append(int(suffix))
    if not shards:
        return load_edgelist(prefix, **kw)
    mine = sorted(s for s in shards if s % nh == h)
    parts = [load_edgelist(f"{prefix}{s}", **kw) for s in mine]
    if not parts:
        return EdgeList()
    m = max(p.m for p in parts)
    n = max(p.n for p in parts)
    return EdgeList(m, n,
                    np.concatenate([p.src for p in parts]),
                    np.concatenate([p.dst for p in parts]),
                    np.concatenate([p.val for p in parts]))
