"""Edge-list container and file I/O.

JAX re-design of GraphMat's edgelist layer
(reference: ``include/GMDP/utils/edgelist.h``).  Where the reference stores an
array-of-structs ``edge_t{src,dst,val}`` and reads files one triple at a time
with ``fread``/``fscanf`` (``edgelist.h:89-151``), we keep a struct-of-arrays
:class:`EdgeList` of numpy vectors (the layout every later stage — sorting,
partitioning, device upload — wants) and read whole files with
``np.fromfile`` / ``np.loadtxt``.

File-format parity with the reference (``edgelist.h:89-240``):

* **binary**: optional 12-byte header of int32 ``(m, n, nnz)`` followed by
  triples ``(src:int32, dst:int32, val:W)`` where ``W`` is the weight dtype
  (int32 / float32 / float64).  With ``edgeweights=False`` the value column is
  absent and every weight is 1.
* **text**: optional ``"m n nnz"`` header line, then ``"src dst [val]"`` rows.
* Vertex ids are **1-based** throughout, as in the reference.
* Sharded datasets are a series of files ``prefix0, prefix1, ...``
  (``edgelist.h:250-274``: rank r reads files ``prefix{r, r+nrank, ...}``).
  :func:`load_edgelist` accepts either an exact path or such a shard prefix.

Known reference quirk: the shipped ``data/*.bin.mtx`` files contain ``nnz+1``
triples with the final one duplicated; the reference's header path allocates
``nnz`` entries so the duplicate is dropped.  We honour the header count, which
yields identical effective contents.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "EdgeList",
    "load_edgelist",
    "write_edgelist",
    "edgelist_from_arrays",
]


@dataclass
class EdgeList:
    """A COO edge list with 1-based vertex ids (struct-of-arrays).

    Mirrors the information content of the reference ``edgelist_t<T>``
    (``edgelist.h:57-86``): dimensions ``m x n`` and ``nnz`` edges.
    """

    m: int = 0
    n: int = 0
    src: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    dst: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    val: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    def copy(self) -> "EdgeList":
        return EdgeList(self.m, self.n, self.src.copy(), self.dst.copy(),
                        self.val.copy())

    def astuple(self):
        return self.src, self.dst, self.val

    def as_records(self) -> set:
        """Set of (src, dst, val) python tuples — order-insensitive compare."""
        return set(zip(self.src.tolist(), self.dst.tolist(), self.val.tolist()))

    def validate(self) -> None:
        if self.nnz:
            assert self.src.min() >= 1 and self.src.max() <= self.m, "src out of range"
            assert self.dst.min() >= 1 and self.dst.max() <= self.n, "dst out of range"

    def __repr__(self):
        return f"EdgeList(m={self.m}, n={self.n}, nnz={self.nnz}, valdtype={self.val.dtype})"


def edgelist_from_arrays(src, dst, val=None, m=None, n=None) -> EdgeList:
    """Build an EdgeList from arrays of 1-based ids; dims default to max id."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if val is None:
        val = np.ones(src.shape[0], np.int32)
    else:
        val = np.asarray(val)
        if val.shape[0] != src.shape[0]:
            raise ValueError("val length mismatch")
    m = int(m if m is not None else (src.max() if src.size else 0))
    n = int(n if n is not None else (dst.max() if dst.size else 0))
    e = EdgeList(m, n, src, dst, val)
    e.validate()
    return e


def _shard_paths(path: str) -> list:
    """Resolve a path or shard prefix to the ordered list of files to read."""
    if os.path.exists(path):
        return [path]
    shards = []
    for p in glob.glob(glob.escape(path) + "*"):
        suffix = p[len(path):]
        if re.fullmatch(r"\d+", suffix):
            shards.append((int(suffix), p))
    shards.sort()
    if not shards:
        raise FileNotFoundError(f"no file or shard series found at '{path}'")
    # The reference reads ranks 0..k consecutively and stops at the first
    # missing index (edgelist.h:250-263); do the same.
    out = []
    for i, (idx, p) in enumerate(shards):
        if idx != i:
            break
        out.append(p)
    return out


def _read_one_binary(path, header, weights, wdtype):
    raw = np.fromfile(path, dtype=np.uint8)
    off = 0
    m = n = None
    nnz = None
    if header:
        hdr = raw[:12].view(np.int32)
        m, n, nnz = int(hdr[0]), int(hdr[1]), int(hdr[2])
        off = 12
    if weights:
        rec = np.dtype([("src", np.int32), ("dst", np.int32), ("val", wdtype)])
    else:
        rec = np.dtype([("src", np.int32), ("dst", np.int32)])
    body = raw[off: off + ((raw.size - off) // rec.itemsize) * rec.itemsize]
    triples = body.view(rec)
    if nnz is not None:
        triples = triples[:nnz]
    src = triples["src"].astype(np.int32)
    dst = triples["dst"].astype(np.int32)
    if weights:
        val = triples["val"].copy()
    else:
        val = np.ones(src.shape[0], wdtype)
    if m is None:
        m = int(src.max()) if src.size else 0
        n = int(dst.max()) if dst.size else 0
    return m, n, src, dst, val


def _parse_text_native(body: bytes, weights, wdtype):
    """Native C++/OpenMP row parser (parallel; ~2.5x np.loadtxt on a
    2-core box, scales with cores); None = fall back."""
    from ..native import load_planner
    lib = load_planner()
    if lib is None or not hasattr(lib, "gm_parse_text_edges") or not body:
        return None
    import ctypes
    wdt = np.dtype(wdtype)
    nmax = body.count(b"\n") + 1
    src = np.empty(nmax, np.int32)
    dst = np.empty(nmax, np.int32)
    if not weights:
        vk, val, vptr = 0, None, None
    else:
        vk = {np.dtype(np.int32): 1, np.dtype(np.float32): 2,
              np.dtype(np.float64): 3}.get(wdt)
        if vk is None:
            return None
        val = np.empty(nmax, wdt)
        vptr = val.ctypes.data_as(ctypes.c_void_p)
    ne = lib.gm_parse_text_edges(body, len(body), vk, src, dst, vptr)
    if ne < 0:
        return None
    if weights:
        return src[:ne].copy(), dst[:ne].copy(), val[:ne].copy()
    return src[:ne].copy(), dst[:ne].copy(), np.ones(ne, wdt)


def _read_one_text(path, header, weights, wdtype):
    with open(path, "rb") as f:
        buf = f.read()
    first = b""
    off = 0
    if header:
        nl = buf.find(b"\n")
        first = buf if nl < 0 else buf[:nl]
        off = len(buf) if nl < 0 else nl + 1

    got = _parse_text_native(buf[off:], weights, wdtype)
    if got is not None:
        src, dst, val = got
    else:
        ncols = 3 if weights else 2
        data = np.loadtxt(path, skiprows=(1 if header else 0), ndmin=2,
                          dtype=np.float64 if np.issubdtype(
                              np.dtype(wdtype), np.floating) else np.int64)
        if data.size == 0:
            data = data.reshape(0, ncols)
        src = data[:, 0].astype(np.int32)
        dst = data[:, 1].astype(np.int32)
        if weights:
            val = data[:, 2].astype(wdtype)
        else:
            val = np.ones(src.shape[0], wdtype)
    if header:
        hm, hn, hnnz = (int(float(x)) for x in first.split()[:3])
        src, dst, val = src[:hnnz], dst[:hnnz], val[:hnnz]
        m, n = hm, hn
    else:
        m = int(src.max()) if src.size else 0
        n = int(dst.max()) if dst.size else 0
    return m, n, src, dst, val


def load_edgelist(path: str, binaryformat: bool = True, header: bool = True,
                  edgeweights: bool = True, wdtype=np.int32) -> EdgeList:
    """Load an edge list from a file or a ``prefix0, prefix1, ...`` series.

    Parity with ``load_edgelist`` (``edgelist.h:242-334``): per-shard dims are
    max-reduced, nnz summed, weights default to 1 when absent.
    """
    wdtype = np.dtype(wdtype)
    paths = _shard_paths(path)
    M = N = 0
    srcs, dsts, vals = [], [], []
    for p in paths:
        if binaryformat:
            m, n, s, d, v = _read_one_binary(p, header, edgeweights, wdtype)
        else:
            m, n, s, d, v = _read_one_text(p, header, edgeweights, wdtype)
        M, N = max(M, m), max(N, n)
        srcs.append(s)
        dsts.append(d)
        vals.append(v)
    e = EdgeList(M, N,
                 np.concatenate(srcs) if srcs else np.empty(0, np.int32),
                 np.concatenate(dsts) if dsts else np.empty(0, np.int32),
                 np.concatenate(vals) if vals else np.empty(0, wdtype))
    return e


def write_edgelist(edgelist: EdgeList, path: str, binaryformat: bool = True,
                   header: bool = True, edgeweights: bool = True,
                   nshards: int | None = None) -> list:
    """Write an edge list; returns the list of files written.

    With ``nshards`` set, writes ``path0..path{nshards-1}`` (the reference's
    per-rank files, ``edgelist.h:208-240``); otherwise a single ``path``.
    """
    if nshards is None:
        chunks = [(path, slice(None))]
    else:
        bounds = np.linspace(0, edgelist.nnz, nshards + 1).astype(np.int64)
        chunks = [(f"{path}{i}", slice(int(bounds[i]), int(bounds[i + 1])))
                  for i in range(nshards)]
    written = []
    for p, sl in chunks:
        s, d, v = edgelist.src[sl], edgelist.dst[sl], edgelist.val[sl]
        if binaryformat:
            with open(p, "wb") as f:
                if header:
                    np.array([edgelist.m, edgelist.n, s.shape[0]],
                             np.int32).tofile(f)
                rec_fields = [("src", np.int32), ("dst", np.int32)]
                if edgeweights:
                    rec_fields.append(("val", v.dtype))
                rec = np.empty(s.shape[0], np.dtype(rec_fields))
                rec["src"], rec["dst"] = s, d
                if edgeweights:
                    rec["val"] = v
                rec.tofile(f)
        else:
            with open(p, "w") as f:
                if header:
                    f.write(f"{edgelist.m} {edgelist.n} {s.shape[0]}\n")
                if np.issubdtype(v.dtype, np.floating):
                    rows = (f"{a} {b} {c}" for a, b, c in zip(s, d, v))
                else:
                    rows = (f"{a} {b} {int(c)}" for a, b, c in zip(s, d, v))
                if not edgeweights:
                    rows = (f"{a} {b}" for a, b in zip(s, d))
                f.write("\n".join(rows))
                if s.shape[0]:
                    f.write("\n")
        written.append(p)
    return written
