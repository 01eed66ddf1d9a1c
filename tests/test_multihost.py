"""Multi-process distributed execution — the reference CI's
``mpirun -np 4 ./testbin/test`` analog (``.travis.yml:25-26``).

Spawns 2 OS processes, each owning 4 virtual CPU devices; the (2, 4)
mesh's row axis spans processes (``hosts_mesh``), so every all_gather('r')
crosses the process boundary over Gloo — real cross-process collectives,
no mocks.  Results must match the single-device engine bit-for-bit on
integers and to fp tolerance on PageRank.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_workers(tmp_path, extra_args=()):
    port = _free_port()
    out = tmp_path / "result.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port), str(out),
         *extra_args],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    logs = [p.communicate(timeout=540)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-3000:]}"
    return np.load(out)


def test_two_process_dist_matches_single_device(tmp_path):
    got = _spawn_workers(tmp_path)

    # single-device oracle (this process, CPU)
    from graphmat import Graph
    from graphmat.apps.bfs import run_bfs
    from graphmat.apps.pagerank import run_pagerank
    from graphmat.utils.generators import rmat_edgelist
    e = rmat_edgelist(8, 8, seed=3)
    pr, _ = run_pagerank(Graph(e))
    n = len(pr)
    np.testing.assert_allclose(got["pagerank"][:n], pr, atol=2e-5)
    depth, _parent, _ = run_bfs(Graph(e, build_in_edges=False), 1)
    np.testing.assert_array_equal(got["depth"][:n], depth)


def test_two_process_sharded_ingest(tmp_path):
    """Distributed ingest: host h loads shard files {h, h+H, ...}, the
    partial lists are exchanged (allgather_edgelist = the reference's
    Isend/Irecv shuffle analog, SpMat.h:171-217), and the result matches
    the single-process whole-file run."""
    from graphmat import Graph
    from graphmat.apps.pagerank import run_pagerank
    from graphmat.io.edgelist import write_edgelist
    from graphmat.utils.generators import rmat_edgelist
    e = rmat_edgelist(8, 8, seed=3)
    # 4 shard files, strided over 2 hosts
    prefix = str(tmp_path / "shard")
    nsh = 4
    for i in range(nsh):
        from graphmat.io.edgelist import EdgeList
        sl = slice(i, None, nsh)
        write_edgelist(EdgeList(e.m, e.n, e.src[sl], e.dst[sl], e.val[sl]),
                       f"{prefix}{i}", binaryformat=False)
    got = _spawn_workers(tmp_path, extra_args=(prefix,))
    pr, _ = run_pagerank(Graph(e))
    n = len(pr)
    np.testing.assert_allclose(got["pagerank"][:n], pr, atol=2e-5)


def test_cli_mesh_env_matches_single_device(tmp_path):
    """GRAPHMAT_MESH=RxC runs the unchanged app CLI 2D-sharded (the
    mpirun-with-same-binary analog); output matches the one-device run."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["GRAPHMAT_PLATFORM"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

    def run(mesh):
        e2 = dict(env)
        e2["GRAPHMAT_MESH"] = mesh
        r = subprocess.run(
            [sys.executable, "-m", "graphmat.apps.pagerank",
             "data/test.bin.mtx"], env=e2, cwd=REPO, timeout=240,
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]
        return [ln for ln in r.stdout.splitlines()
                if ln and ln[0].isdigit() and " : " in ln]

    single = run("")
    assert single and single == run("2x4")
