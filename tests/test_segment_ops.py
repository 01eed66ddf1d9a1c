"""Segment-reduce unit tests (the SpMV ⊕ stage) vs numpy oracles —
the analog of ``test/test_spmv.cpp`` and ``test/test_reduce.cpp``."""

import jax.numpy as jnp
import numpy as np
import pytest

from graphmat.core.types import ANY, MAX, MIN, SUM, Monoid
from graphmat.ops.segment import (masked_fill_identity, segment_any,
                                  segment_reduce)


def make_sorted_segments(e=257, nseg=50, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, nseg, e)).astype(np.int32)
    data = rng.standard_normal(e).astype(np.float32)
    return ids, data


@pytest.mark.parametrize("monoid,npop,init", [
    (SUM, np.add, 0.0),
    (MIN, np.minimum, np.inf),
    (MAX, np.maximum, -np.inf),
])
def test_named_monoids(monoid, npop, init):
    ids, data = make_sorted_segments()
    out = segment_reduce(monoid, jnp.asarray(data), jnp.asarray(ids), 50)
    expect = np.full(50, init, np.float32)
    for i, d in zip(ids, data):
        expect[i] = npop(expect[i], d)
    mask = np.isin(np.arange(50), ids)
    np.testing.assert_allclose(np.asarray(out)[mask], expect[mask], rtol=1e-6)


def test_generic_monoid_matches_sum():
    ids, data = make_sorted_segments(e=300, nseg=40, seed=1)
    gen = Monoid("generic", combine_fn=lambda a, b: a + b,
                 identity_fn=lambda dt: 0)
    out = segment_reduce(gen, jnp.asarray(data), jnp.asarray(ids), 40)
    ref = segment_reduce(SUM, jnp.asarray(data), jnp.asarray(ids), 40)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_generic_monoid_nonlinear():
    """A genuinely non-jnp-named combine: max-abs with sign kept."""
    ids = np.array([0, 0, 1, 2, 2, 2], np.int32)
    data = np.array([1.0, -3.0, 2.0, -1.0, 0.5, 4.0], np.float32)

    def combine(a, b):
        return jnp.where(jnp.abs(a) >= jnp.abs(b), a, b)

    gen = Monoid("generic", combine_fn=combine, identity_fn=lambda dt: 0)
    out = np.asarray(segment_reduce(gen, jnp.asarray(data),
                                    jnp.asarray(ids), 4))
    np.testing.assert_allclose(out[:3], [-3.0, 2.0, 4.0])


def test_generic_monoid_2d():
    ids = np.array([0, 0, 2], np.int32)
    data = np.arange(6, dtype=np.float32).reshape(3, 2)
    gen = Monoid("generic", combine_fn=lambda a, b: a + b,
                 identity_fn=lambda dt: 0)
    out = np.asarray(segment_reduce(gen, jnp.asarray(data),
                                    jnp.asarray(ids), 3))
    np.testing.assert_allclose(out[0], [2.0, 4.0])
    np.testing.assert_allclose(out[1], [0.0, 0.0])
    np.testing.assert_allclose(out[2], [4.0, 5.0])


def test_segment_any():
    ids = np.array([0, 0, 1, 3, 3], np.int32)
    mask = np.array([False, True, False, False, False])
    out = np.asarray(segment_any(jnp.asarray(mask), jnp.asarray(ids), 5))
    assert out.tolist() == [True, False, False, False, False]


def test_masked_fill_identity_tree():
    mask = jnp.asarray(np.array([True, False]))
    tree = {"a": jnp.asarray(np.array([1.0, 2.0], np.float32)),
            "b": jnp.asarray(np.array([[1, 2], [3, 4]], np.int32))}
    out = masked_fill_identity({"a": MIN, "b": SUM}, tree, mask)
    assert np.asarray(out["a"])[1] == np.inf
    assert np.asarray(out["b"])[1].tolist() == [0, 0]


def test_spmv_identity():
    """y = I·x == x — mirrors ``test/test_spmv.cpp:38-103``."""
    from graphmat import Graph
    from graphmat.utils.generators import identity_edgelist
    n = 70
    g = Graph(identity_edgelist(n))
    rng = np.random.default_rng(4)
    x = rng.standard_normal(g.n_pad).astype(np.float32)
    ea = g.out_edges
    gathered = jnp.asarray(x)[ea.senders] * ea.vals.astype(jnp.float32)
    gathered = jnp.where(ea.valid, gathered, 0)
    y = segment_reduce(SUM, gathered, ea.receivers, g.n_pad)
    np.testing.assert_allclose(np.asarray(y)[:n], x[:n], rtol=1e-6)


def test_collect_neighbors_direct():
    """GetNeighbors analog (``test/test_get_neighbors.cpp``): every vertex
    collects its sorted out-neighbor ids."""
    import jax.numpy as jnp
    from graphmat import Graph
    from graphmat.ops.neighbors import PAD_ID, collect_neighbors
    from graphmat.utils.generators import random_edgelist
    e = random_edgelist(40, 4, seed=19)
    g = Graph(e)
    nb = np.asarray(collect_neighbors(g, receiver="src"))
    expect = {}
    for s, d, _ in e.as_records():
        expect.setdefault(s, []).append(d)
    for v in range(1, 41):
        want = sorted(expect.get(v, []))
        got = [int(x) for x in nb[v - 1] if x != PAD_ID]
        assert got == want, (v, got, want)
