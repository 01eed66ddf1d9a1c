"""Golden parity vs outputs of the ACTUAL reference binaries.

The files in ``tests/golden/`` were captured from GraphMat v2.0 built
from ``/root/reference`` with g++ (single rank: a 15-function MPI stub
with a self-send queue plus a raw-byte boost-archive stub — the
reference's Makefile wants icpc + MPI + Boost, none of which are in
this image; the stub build is documented in PARITY.md).  Commands:

    PageRank data/test.bin.mtx            -> pagerank_test.txt
    BFS data/test.bin.mtx 1               -> bfs_test_s1.txt
    SSSP data/test.bin.mtx 1              -> sssp_test_s1.txt
    TopologicalSort data/2_10_...mtx      -> toposort_2_10.txt
    TriangleCounting data/2_10_...mtx     -> tc_2_10.txt
    IncrementalPageRank data/test.bin.mtx -> incpr_test.txt
    DeltaStepping data/test.bin.mtx 3 1   -> deltastepping_test_d3_s1.txt
    SGD data/ratings7.bin.mtx             -> sgd_ratings7.txt
    LDA data/ratings7.bin.mtx 3 4 10      -> lda_ratings7.txt

Each test drives OUR CLI on the same fixture and compares the
user-visible numbers.  Where the reference's answer is one of several
valid ones (BFS parents under overwrite-reduce), the test validates
tree-validity instead of equality.
"""

import io
import contextlib
import importlib
import os
import re

import numpy as np
import pytest

GOLD = os.path.join(os.path.dirname(__file__), "golden")
DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def run_cli(mod, args):
    m = importlib.import_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m._main(args)
    return buf.getvalue()


def gold(name):
    with open(os.path.join(GOLD, name)) as f:
        return f.read()


def fixture(name):
    return os.path.join(DATA, name)


def test_pagerank_matches_reference_binary():
    ref = gold("pagerank_test.txt")
    ours = run_cli("graphmat.apps.pagerank", [fixture("test.bin.mtx")])
    ref_vals = {int(m[0]): (int(m[1]), float(m[2])) for m in re.findall(
        r"^(\d+) : (\d+) ([\d.]+)$", ref, re.M)}
    our_vals = {int(m[0]): float(m[1]) for m in re.findall(
        r"^(\d+) : ([\d.]+)$", ours, re.M)}
    assert len(ref_vals) == 8 and len(our_vals) == 8
    for v, (_deg, pr) in ref_vals.items():
        assert abs(our_vals[v] - pr) < 2e-5, (v, our_vals[v], pr)
    # the reference's PR loop converges in 6 iterations; ours must too
    assert "Completed 6 iterations" in ref
    assert "Completed 6 iterations" in ours


def test_bfs_matches_reference_binary():
    ref = gold("bfs_test_s1.txt")
    ours = run_cli("graphmat.apps.bfs", [fixture("test.bin.mtx"), "1"])
    ref_d = {int(m[0]): int(m[1]) for m in re.findall(
        r"^Depth (\d+) : (\d+) parent", ref, re.M)}
    our = {int(m[0]): (int(m[1]), int(m[2])) for m in re.findall(
        r"^Depth (\d+) : (\d+) parent: (-?\d+)", ours, re.M)}
    assert {v: d for v, (d, _p) in our.items()} == ref_d
    assert "Reachable vertices = 8" in ref
    assert "Reachable vertices = 8" in ours
    # parents: overwrite-reduce is nondeterministic in the reference, so
    # require tree-validity (parent at depth-1 with a real edge) instead
    import graphmat as gm
    e = gm.load_edgelist(fixture("test.bin.mtx"))
    edges = set(zip(e.src.tolist(), e.dst.tolist()))
    for v, (d, p) in our.items():
        if v == 1:
            assert d == 0 and p == -1
        else:
            assert our[p][0] == d - 1 and (p, v) in edges, (v, d, p)


def test_sssp_matches_reference_binary():
    ref = gold("sssp_test_s1.txt")
    ours = run_cli("graphmat.apps.sssp", [fixture("test.bin.mtx"), "1"])
    pat = r"^(\d+) : distance = (\d+)$"
    assert re.findall(pat, ref, re.M) == re.findall(pat, ours, re.M)


def test_toposort_matches_reference_binary():
    ref = gold("toposort_2_10.txt")
    ours = run_cli("graphmat.apps.topological_sort",
                   [fixture("2_10_upper_triangle.bin.mtx")])
    pat = r"^Top Sort order (\d+) : (\d+)$"
    assert re.findall(pat, ref, re.M) == re.findall(pat, ours, re.M)


def test_triangle_counting_matches_reference_binary():
    ref = gold("tc_2_10.txt")
    ours = run_cli("graphmat.apps.triangle_counting",
                   [fixture("2_10_upper_triangle.bin.mtx")])
    m = re.search(r"Total triangles = (\d+)", ref)
    assert m and f"Total triangles = {m[1]}" in ours


def test_incremental_pagerank_matches_reference_binary():
    ref = gold("incpr_test.txt")
    ours = run_cli("graphmat.apps.incremental_pagerank",
                   [fixture("test.bin.mtx")])
    ref_vals = {int(m[0]): float(m[2]) for m in re.findall(
        r"^(\d+) : (\d+) ([\d.]+)$", ref, re.M)}
    our_vals = {int(m[0]): float(m[2]) for m in re.findall(
        r"^(\d+) : (\d+) ([\d.]+)$", ours, re.M)}
    assert len(ref_vals) == 8
    for v, pr in ref_vals.items():
        # the incremental update reorders float adds (ref itself differs
        # from plain PageRank in the 6th decimal on vertex 6)
        assert abs(our_vals[v] - pr) < 5e-5, (v, our_vals[v], pr)


def test_delta_stepping_matches_reference_binary():
    ref = gold("deltastepping_test_d3_s1.txt")
    ours = run_cli("graphmat.apps.delta_stepping",
                   [fixture("test.bin.mtx"), "3", "1"])
    pat = r"^(\d+) : distance = (\d+)$"
    assert re.findall(pat, ref, re.M) == re.findall(pat, ours, re.M)
    m = re.search(r"Number of buckets processed = (\d+)", ref)
    assert m and f"Number of buckets processed = {m[1]}" in ours


def test_sgd_matches_reference_binary():
    ref = gold("sgd_ratings7.txt")
    ours = run_cli("graphmat.apps.sgd", [fixture("ratings7.bin.mtx")])
    ref_rmse = [float(x) for x in re.findall(
        r"RMSE error = ([\d.]+) per edge", ref)]
    our_rmse = [float(x) for x in re.findall(
        r"RMSE error = ([\d.]+) per edge", ours)]
    assert len(ref_rmse) == 2 and len(our_rmse) == 2
    # init RMSE is bit-exact (glibc rand_r parity); final reorders adds
    assert abs(our_rmse[0] - ref_rmse[0]) < 1e-5, (our_rmse, ref_rmse)
    assert abs(our_rmse[1] - ref_rmse[1]) < 1e-3, (our_rmse, ref_rmse)
    ref_rows = re.findall(r"^(\d+) : ((?: +[\d.]+)+)", ref, re.M)
    our_rows = re.findall(r"^(\d+) : ((?: +[\d.]+)+)", ours, re.M)
    ref_tab = {int(v): np.array(r.split(), float) for v, r in ref_rows}
    our_tab = {int(v): np.array(r.split(), float) for v, r in our_rows}
    for v, row in ref_tab.items():
        np.testing.assert_allclose(our_tab[v], row, atol=0.015)


def test_lda_matches_reference_binary():
    ref = gold("lda_ratings7.txt")
    ours = run_cli("graphmat.apps.lda",
                   [fixture("ratings7.bin.mtx"), "3", "4", "10"])
    m = re.search(r"Total Loglikelihood = (-?[\d.]+)", ref)
    mo = re.search(r"Total Loglikelihood = (-?[\d.]+)", ours)
    assert m and mo
    assert abs(float(mo[1]) - float(m[1])) < 2e-3, (mo[1], m[1])
