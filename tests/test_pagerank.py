"""PageRank end-to-end vs the per-edge numpy oracle (reference formula,
``src/PageRank.cpp:94-110``)."""

import numpy as np
import pytest

from graphmat import Graph, load_edgelist
from graphmat.apps.pagerank import run_pagerank
from graphmat.utils.generators import (chain_edgelist,
                                       circular_chain_edgelist,
                                       random_edgelist)
from oracle import OracleGraph, oracle_run, vp_array


class OracleDegree:
    order = "in"
    activity = "active"

    def send(self, vp):
        return 1, True

    def process(self, msg, ev, vpr):
        return msg

    def combine(self, a, b):
        return a + b

    def apply(self, u, vp):
        vp["degree"] = u
        return vp

    def changed(self, old, new):
        return old != new


class OraclePR:
    order = "out"
    activity = "all"

    def __init__(self, alpha=0.3):
        self.alpha = alpha

    def send(self, vp):
        d = vp["degree"]
        return (np.float32(0.0) if d == 0
                else np.float32(vp["pagerank"] / np.float32(d))), True

    def process(self, msg, ev, vpr):
        return msg

    def combine(self, a, b):
        return np.float32(a + b)

    def apply(self, u, vp):
        vp["pagerank"] = np.float32(self.alpha + (1 - self.alpha) * u)
        return vp

    def changed(self, old, new):
        return abs(old["pagerank"] - new["pagerank"]) > 1e-5


def oracle_pagerank(e):
    og = OracleGraph(e, {"pagerank": np.float32(0.3), "degree": 0})
    og.active[:] = True
    oracle_run(og, OracleDegree(), iterations=1)
    niter = oracle_run(og, OraclePR(), iterations=-1)
    return vp_array(og, "pagerank"), vp_array(og, "degree"), niter


@pytest.mark.parametrize("gen", [
    lambda: load_edgelist("data/test.bin.mtx"),
    lambda: chain_edgelist(17),
    lambda: circular_chain_edgelist(16),
    lambda: random_edgelist(64, 4, seed=8),
])
def test_pagerank_matches_oracle(gen):
    e = gen()
    expect_pr, expect_deg, expect_iter = oracle_pagerank(e)
    g = Graph(e)
    pr, niter = run_pagerank(g)
    assert niter == expect_iter
    np.testing.assert_array_equal(g.vp_numpy()["degree"], expect_deg)
    np.testing.assert_allclose(pr, expect_pr, rtol=1e-5, atol=1e-6)


def test_pagerank_fixed_iterations():
    e = load_edgelist("data/test.bin.mtx")
    g = Graph(e)
    pr3, niter = run_pagerank(g, iterations=3)
    assert niter == 3
    g2 = Graph(e)
    prc, _ = run_pagerank(g2)
    assert not np.allclose(pr3, prc, atol=1e-7)  # 3 iters ≠ converged


def test_pagerank_sums_bounded():
    """Invariant: pageranks stay in [alpha, 1] for a stochastic-ish graph."""
    e = circular_chain_edgelist(32)
    g = Graph(e)
    pr, _ = run_pagerank(g)
    assert (pr >= 0.3 - 1e-6).all()
    np.testing.assert_allclose(pr, 1.0, atol=1e-3)  # ring: uniform pr = 1
