"""Edge-list transformation tests — mirrors ``test/test_edgelist_utils.cpp``.
"""

import numpy as np

from graphmat.io import transforms as tf
from graphmat.io.edgelist import edgelist_from_arrays
from graphmat.utils.generators import random_edgelist


def make(src, dst, val=None, n=10):
    return edgelist_from_arrays(src, dst, val, m=n, n=n)


def test_remove_selfedges():
    e = make([1, 2, 3, 4], [1, 3, 3, 5])
    r = tf.remove_selfedges(e)
    assert r.as_records() == {(2, 3, 1), (4, 5, 1)}


def test_remove_duplicates_keeps_first():
    e = make([2, 1, 2, 1], [3, 2, 3, 2], [10, 20, 30, 40])
    r = tf.remove_duplicate_edges(e)
    # stable sort by (src,dst): first occurrence in file order wins
    assert r.as_records() == {(1, 2, 20), (2, 3, 10)}


def test_bidirectional():
    e = make([1, 2], [2, 3], [5, 6])
    r = tf.create_bidirectional_edges(e)
    assert r.as_records() == {(1, 2, 5), (2, 1, 5), (2, 3, 6), (3, 2, 6)}


def test_convert_to_dag():
    e = make([3, 1, 5], [2, 4, 5], [1, 2, 3])
    r = tf.convert_to_dag(e)
    assert (r.src <= r.dst).all()
    assert r.as_records() == {(2, 3, 1), (1, 4, 2), (5, 5, 3)}


def test_upper_triangular():
    e = make([3, 1, 5, 2, 3], [2, 4, 5, 3, 2], [1, 2, 3, 4, 5])
    r = tf.convert_to_upper_triangular(e)
    assert (r.src < r.dst).all()
    pairs = set(zip(r.src.tolist(), r.dst.tolist()))
    assert pairs == {(2, 3), (1, 4)}
    assert len(pairs) == r.nnz


def test_filter_edges():
    e = make([1, 2, 3], [2, 3, 4], [1, 5, 9])
    light = tf.filter_edges(e, lambda s, d, v: v <= 5)
    heavy = tf.filter_edges(e, lambda s, d, v: v > 5)
    assert light.nnz == 2 and heavy.nnz == 1
    assert light.as_records() | heavy.as_records() == e.as_records()


def test_random_edge_weights_range():
    e = random_edgelist(100, 5, seed=1)
    r = tf.random_edge_weights(e, 64, seed=2)
    assert r.val.min() >= 1 and r.val.max() <= 64
    assert r.nnz == e.nnz


def test_randomize_vertex_ids_preserves_structure():
    e = random_edgelist(50, 4, seed=7)
    r, perm = tf.randomize_vertex_ids(e, seed=9)
    assert sorted(perm.tolist()) == list(range(1, 51))
    # inverse-permute back and compare
    inv = np.empty(50, np.int32)
    inv[perm - 1] = np.arange(1, 51)
    back = edgelist_from_arrays(inv[r.src - 1], inv[r.dst - 1], r.val,
                                m=50, n=50)
    assert back.as_records() == e.as_records()


def test_randomize_direction_preserves_pairs():
    e = random_edgelist(30, 4, seed=11)
    r = tf.randomize_edge_direction(e, seed=13)
    a = {frozenset((s, d)) for s, d in zip(e.src, e.dst)}
    b = {frozenset((s, d)) for s, d in zip(r.src, r.dst)}
    assert a == b


def test_randomize_vertex_ids_glibc_bit_parity():
    """The id permutation must be byte-identical to the reference's
    srand(5)+rand()%m sequential swap (edgelist.h:337-366).  Ground
    truth below was produced by C code calling the real glibc
    srand/rand (see utils/reference_rng.py glibc_rand_np docstring)."""
    import numpy as np
    from graphmat.io.transforms import randomize_vertex_ids
    from graphmat.utils.reference_rng import (glibc_rand_np,
                                              glibc_square_mapping_np)
    # raw rand() sequence after srand(5)
    expect_seq = [590011675, 99788765, 2131925610, 171864072, 317159276,
                  171035632, 602511920, 963050649, 1069979073, 1919854381]
    np.testing.assert_array_equal(glibc_rand_np(5, 10), expect_seq)
    # m=8 mapping from the same C run
    np.testing.assert_array_equal(glibc_square_mapping_np(8),
                                  [6, 7, 2, 3, 4, 0, 1, 5])
    # m=1000 mapping FNV-1a hash from the C run
    m1000 = glibc_square_mapping_np(1000)
    h = 1469598103934665603
    for v in m1000:
        h = ((h ^ int(v)) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    assert h == 10847347724954123681
    assert m1000[:5].tolist() == [228, 765, 249, 998, 276]
    # the native C path (when available) must agree with the python one
    from graphmat import edgelist_from_arrays
    e = edgelist_from_arrays([1, 2, 3], [2, 3, 1], m=1000, n=1000)
    out, perm = randomize_vertex_ids(e, seed=5)
    np.testing.assert_array_equal(perm, m1000 + 1)
    np.testing.assert_array_equal(out.src, perm[e.src - 1])
