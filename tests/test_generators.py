"""Generator fixtures (the reference's ``test/generator.h`` analog) + RMAT.

The RMAT tests run both the native (C++/OpenMP, counter-based splitmix64)
and numpy paths and assert the same invariants on each: no self loops,
dedup, id range, determinism per seed, power-law degree skew.
"""

import numpy as np
import pytest

from graphmat.native import native_available
from graphmat.utils.generators import (chain_edgelist,
                                       circular_chain_edgelist,
                                       dense_edgelist, identity_edgelist,
                                       rmat_edgelist,
                                       upper_triangular_edgelist)


def test_fixture_shapes():
    assert identity_edgelist(5).nnz == 5
    assert chain_edgelist(5).nnz == 4
    assert circular_chain_edgelist(5).nnz == 5
    assert upper_triangular_edgelist(5).nnz == 10
    assert dense_edgelist(4).nnz == 16


NATIVE_PARAMS = [False] + ([None] if native_available() else [])


@pytest.mark.parametrize("native", NATIVE_PARAMS,
                         ids=["numpy", "native"][:len(NATIVE_PARAMS)])
def test_rmat_invariants(native):
    e = rmat_edgelist(10, 8, seed=1, native=native)
    assert e.m == e.n == 1024
    assert (e.src != e.dst).all()
    assert e.src.min() >= 1 and max(e.src.max(), e.dst.max()) <= 1024
    key = e.src.astype(np.int64) << 32 | e.dst
    assert np.unique(key).size == key.size  # dedup'd
    # deterministic per seed, different across seeds
    e2 = rmat_edgelist(10, 8, seed=1, native=native)
    assert np.array_equal(e.src, e2.src) and np.array_equal(e.dst, e2.dst)
    e3 = rmat_edgelist(10, 8, seed=2, native=native)
    assert not np.array_equal(e.src, e3.src)
    # power-law skew: hubs far above the median degree
    deg = np.bincount(e.src - 1, minlength=1024)
    assert deg.max() > 10 * max(1.0, float(np.median(deg)))
    # BOTH endpoints must be skewed: RMAT(0.57,...) concentrates src AND
    # dst toward low ids (the a-quadrant).  A threshold bug once swapped
    # the a/b quadrants, pushing receivers toward HIGH ids and killing
    # the diagonal dominance (clustering) while sender hubs survived
    deg_in = np.bincount(e.dst - 1, minlength=1024)
    assert deg_in.max() > 10 * max(1.0, float(np.median(deg_in)))
    assert deg[:256].sum() > deg[768:].sum()
    assert deg_in[:256].sum() > deg_in[768:].sum()


@pytest.mark.parametrize("native", NATIVE_PARAMS,
                         ids=["numpy", "native"][:len(NATIVE_PARAMS)])
def test_rmat_clustering(native):
    """The generator must produce RMAT clustering, not just hubby
    degrees: an a-dominant RMAT at scale 10 has tens of thousands of
    triangles where a same-size uniform graph has ~a hundred (the
    quadrant-swap bug measured 1.5K at EVERY scale)."""
    from graphmat.ops.triangles import count_triangles_bucketed
    e = rmat_edgelist(10, 8, seed=1, native=native)
    s0 = (e.src - 1).astype(np.int64)
    r0 = (e.dst - 1).astype(np.int64)
    _, tri = count_triangles_bucketed(s0, r0, 1024)
    assert tri > 10_000, f"RMAT clustering missing: {tri} triangles"


@pytest.mark.parametrize("native", NATIVE_PARAMS,
                         ids=["numpy", "native"][:len(NATIVE_PARAMS)])
def test_rmat_weights_and_nodedup(native):
    ew = rmat_edgelist(7, 4, seed=2, weight_range=5, native=native)
    assert ew.val.min() >= 1 and ew.val.max() <= 5
    en = rmat_edgelist(8, 8, seed=3, dedup=False, native=native)
    assert (en.src != en.dst).all()
    assert en.nnz >= rmat_edgelist(8, 8, seed=3, native=native).nnz
