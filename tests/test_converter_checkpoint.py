"""graph_converter CLI and checkpoint tests."""

import numpy as np

from graphmat import Graph, load_edgelist
from graphmat.io.converter import run as converter_run
from graphmat.utils.checkpoint import (load_edgelist_checkpoint,
                                       load_graph_state,
                                       save_edgelist_checkpoint,
                                       save_graph_state,
                                       save_vertexproperty)
from graphmat.utils.generators import random_edgelist


def test_converter_binary_to_text(tmp_path):
    out = str(tmp_path / "out.txt")
    rc = converter_run(["data/test.bin.mtx", out,
                        "--inputformat", "0", "--outputformat", "1",
                        "--selfloops", "1", "--duplicatededges", "1"])
    assert rc == 0
    r = load_edgelist(out, binaryformat=False)
    assert r.as_records() == load_edgelist("data/test.bin.mtx").as_records()


def test_converter_uppertriangular_dedup(tmp_path):
    src = str(tmp_path / "in.txt")
    out = str(tmp_path / "out.bin")
    with open(src, "w") as f:
        f.write("5 5 5\n3 2 1\n2 3 9\n1 1 4\n4 5 2\n4 5 7\n")
    rc = converter_run([src, out, "--uppertriangular"])
    assert rc == 0
    r = load_edgelist(out)
    pairs = set(zip(r.src.tolist(), r.dst.tolist()))
    assert pairs == {(2, 3), (4, 5)}  # self loop removed, dups merged


def test_converter_random_weights_and_split(tmp_path):
    out = str(tmp_path / "out")
    rc = converter_run(["data/test.bin.mtx", out, "--inputformat", "0",
                        "--outputedgeweights", "3", "--r", "16",
                        "--split", "3"])
    assert rc == 0
    r = load_edgelist(out)  # reads shard series out0..out2
    assert r.nnz == 13
    assert r.val.min() >= 1 and r.val.max() <= 16


def test_converter_conflicting_flags(tmp_path):
    rc = converter_run(["data/test.bin.mtx", str(tmp_path / "x"),
                        "--uppertriangular", "--bidirectional"])
    assert rc == 1


def test_converter_checkpoint_format(tmp_path):
    ck = str(tmp_path / "g")
    rc = converter_run(["data/test.bin.mtx", ck, "--inputformat", "0",
                        "--outputformat", "2"])
    assert rc == 0
    e = load_edgelist_checkpoint(ck)
    assert e.as_records() == load_edgelist("data/test.bin.mtx").as_records()


def test_edgelist_checkpoint_roundtrip(tmp_path):
    e = random_edgelist(40, 4, seed=2, weight_range=9)
    save_edgelist_checkpoint(e, str(tmp_path / "ck"))
    r = load_edgelist_checkpoint(str(tmp_path / "ck"))
    assert r.as_records() == e.as_records()
    assert (r.m, r.n) == (e.m, e.n)


def test_graph_state_checkpoint_roundtrip(tmp_path):
    from graphmat.apps.pagerank import run_pagerank
    e = random_edgelist(30, 3, seed=3)
    g = Graph(e)
    pr, _ = run_pagerank(g)
    save_graph_state(g, str(tmp_path / "st"))

    g2 = Graph(e)
    load_graph_state(g2, str(tmp_path / "st"))
    np.testing.assert_allclose(g2.vp_numpy()["pagerank"], pr)
    np.testing.assert_array_equal(np.asarray(g2.active),
                                  np.asarray(g.active))


def test_graph_state_checkpoint_cross_topology(tmp_path):
    """Single-device state restores onto a 2x4 mesh graph (the reference
    refuses rank-count changes — we must not, SURVEY §5)."""
    import jax
    from graphmat.parallel.dist_graph import DistGraph
    from graphmat.parallel.mesh import make_mesh
    from graphmat.apps.pagerank import run_pagerank
    e = random_edgelist(30, 3, seed=4)
    g = Graph(e)
    pr, _ = run_pagerank(g)
    save_graph_state(g, str(tmp_path / "st"))

    mesh = make_mesh(jax.devices()[:8], (2, 4))
    gd = DistGraph(e, mesh)
    load_graph_state(gd, str(tmp_path / "st"))
    np.testing.assert_allclose(gd.vp_numpy()["pagerank"], pr)


def test_graph_state_large_frontier_roundtrip(tmp_path):
    """A ~1e5-vertex frontier restores via ONE vectorized device_put (the
    old per-index loop would take O(frontier) dispatches) and survives a
    permuted graph round trip exactly."""
    n = 120_000
    e = random_edgelist(n, 2, seed=6)
    g = Graph(e, permute=True)
    g.init_vertexproperty(x=np.arange(n, dtype=np.int32))
    rng = np.random.default_rng(0)
    mask = rng.random(n) < 0.8
    g.set_active_mask(mask)
    save_graph_state(g, str(tmp_path / "big"))

    g2 = Graph(e, permute="degree")   # different internal permutation
    load_graph_state(g2, str(tmp_path / "big"))
    # active mask in ORIGINAL order must match exactly
    act2 = np.asarray(g2.active)
    orig2 = act2[g2.perm] if g2.perm is not None else act2[:n]
    np.testing.assert_array_equal(orig2, mask)
    np.testing.assert_array_equal(g2.vp_numpy()["x"], np.arange(n))


def test_save_vertexproperty_text(tmp_path):
    e = random_edgelist(10, 2, seed=5)
    g = Graph(e)
    g.init_vertexproperty(x=np.arange(10, dtype=np.int32))
    p = str(tmp_path / "vp.txt")
    save_vertexproperty(g, p, "x")
    lines = open(p).read().strip().split("\n")
    assert lines[0] == "1 0" and lines[9] == "10 9"


def test_orbax_sharded_state_roundtrip_across_meshes(tmp_path):
    """Device-sharded orbax checkpoint restores onto a DIFFERENT mesh
    shape (the reference's GraphMatBin refuses exactly this,
    Graph.h:165-175)."""
    import jax
    import numpy as np
    from graphmat.parallel.dist_graph import DistGraph
    from graphmat.parallel.mesh import make_mesh
    from graphmat.utils.checkpoint_orbax import (load_sharded_state,
                                                 save_sharded_state)
    from graphmat.utils.generators import random_edgelist

    e = random_edgelist(40, 3, seed=5)
    mesh_a = make_mesh(jax.devices()[:8], (2, 4))
    g1 = DistGraph(e, mesh_a, seg_align=8)
    g1.init_vertexproperty(val=np.arange(1, g1.n + 1, dtype=np.int32),
                           w=np.float32(0.5))
    g1.set_all_active()
    path = str(tmp_path / "orbax_ckpt")
    save_sharded_state(g1, path)

    mesh_b = make_mesh(jax.devices()[:4], (4, 1))
    g2 = DistGraph(e, mesh_b, seg_align=8)
    g2.init_vertexproperty(val=np.int32(0), w=np.float32(0))
    load_sharded_state(g2, path)
    np.testing.assert_array_equal(g2.vp_numpy()["val"],
                                  g1.vp_numpy()["val"])
    assert bool(np.asarray(g2.active)[: g2.n].all())
