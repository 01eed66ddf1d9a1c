"""Edge-list I/O tests — mirrors ``test/test_io.cpp:39-166`` (write→read
round-trips over {text,binary}×{header}×{weights}) plus fixture-content
checks against the shipped GraphMat data files."""

import numpy as np
import pytest

from graphmat.io.edgelist import (EdgeList, edgelist_from_arrays,
                                  load_edgelist, write_edgelist)

DATA = "data"


def random_edgelist(n=50, nnz=200, seed=3, wdtype=np.int32):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, nnz).astype(np.int32)
    dst = rng.integers(1, n + 1, nnz).astype(np.int32)
    if np.issubdtype(np.dtype(wdtype), np.floating):
        val = rng.random(nnz).astype(wdtype)
    else:
        val = rng.integers(1, 100, nnz).astype(wdtype)
    return edgelist_from_arrays(src, dst, val, m=n, n=n)


def test_fixture_test_bin_mtx():
    e = load_edgelist(f"{DATA}/test.bin.mtx")
    assert (e.m, e.n, e.nnz) == (8, 8, 13)
    recs = e.as_records()
    assert (1, 2, 1) in recs and (6, 8, 1) in recs
    assert e.src.min() >= 1 and e.dst.max() <= 8


def test_fixture_upper_triangle():
    e = load_edgelist(f"{DATA}/2_10_upper_triangle.bin.mtx")
    assert (e.m, e.n, e.nnz) == (1024, 1024, 15069)
    assert (e.src < e.dst).all()  # strictly upper triangular


def test_fixture_ratings7():
    e = load_edgelist(f"{DATA}/ratings7.bin.mtx")
    assert (e.m, e.n, e.nnz) == (7, 7, 7)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("header", [True, False])
@pytest.mark.parametrize("weights", [True, False])
def test_roundtrip(tmp_path, binary, header, weights):
    e = random_edgelist()
    p = str(tmp_path / "edges")
    write_edgelist(e, p, binaryformat=binary, header=header,
                   edgeweights=weights)
    r = load_edgelist(p, binaryformat=binary, header=header,
                      edgeweights=weights)
    assert r.nnz == e.nnz
    np.testing.assert_array_equal(r.src, e.src)
    np.testing.assert_array_equal(r.dst, e.dst)
    if weights:
        np.testing.assert_array_equal(r.val, e.val)
    else:
        assert (r.val == 1).all()
    if header:
        assert (r.m, r.n) == (e.m, e.n)


@pytest.mark.parametrize("wdtype", [np.float32, np.float64])
def test_roundtrip_float_weights(tmp_path, wdtype):
    e = random_edgelist(wdtype=wdtype)
    p = str(tmp_path / "edges")
    write_edgelist(e, p)
    r = load_edgelist(p, wdtype=wdtype)
    np.testing.assert_allclose(r.val, e.val)


def test_sharded_roundtrip(tmp_path):
    """Multi-file prefix series, like the reference's per-rank files
    (``edgelist.h:250-274``)."""
    e = random_edgelist(nnz=100)
    p = str(tmp_path / "shard")
    files = write_edgelist(e, p, nshards=4)
    assert len(files) == 4
    r = load_edgelist(p)
    assert r.nnz == e.nnz
    assert r.as_records() == e.as_records()
    assert (r.m, r.n) == (e.m, e.n)


def test_load_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_edgelist(str(tmp_path / "nope"))


def test_app_cli_mains_smoke(capsys):
    """Every app CLI entry point runs on the fixtures (reference binary
    parity)."""
    from graphmat.apps import (bfs, delta_stepping, incremental_pagerank,
                               pagerank, sgd, sssp, topological_sort,
                               triangle_counting)
    assert pagerank._main(["data/test.bin.mtx"]) == 0
    assert bfs._main(["data/test.bin.mtx", "1"]) == 0
    assert sssp._main(["data/test.bin.mtx", "1"]) == 0
    assert delta_stepping._main(["data/test.bin.mtx", "3", "1"]) == 0
    assert topological_sort._main(["data/test.bin.mtx"]) == 0
    assert incremental_pagerank._main(["data/test.bin.mtx"]) == 0
    assert triangle_counting._main(["data/2_10_upper_triangle.bin.mtx"]) == 0
    assert sgd._main(["data/ratings7.bin.mtx"]) == 0
    out = capsys.readouterr().out
    assert "Reachable vertices = 8" in out
    assert "Total triangles = 17158" in out
    # usage lines on missing args
    assert pagerank._main([]) == 0
    assert bfs._main([]) == 0
