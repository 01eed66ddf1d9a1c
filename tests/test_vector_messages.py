"""K-wide messages ([E, K] ⊗ and ⊕) — one SGD and one LDA step against
the per-edge numpy oracles, at widths around the old 32-lane boundary."""

import numpy as np
import pytest

from graphmat import Graph
from graphmat.apps.lda import run_lda
from graphmat.apps.sgd import run_sgd
from graphmat.utils.generators import random_edgelist
from test_ml_apps import bipartite_edges, lda_oracle, sgd_oracle

WIDTHS = (1, 8, 20, 32, 33, 40)


@pytest.mark.parametrize("k", WIDTHS)
def test_sgd_step_matches_oracle(k):
    e = random_edgelist(60, 4, seed=k, weight_range=5)
    lv_o, r0_o, r1_o = sgd_oracle(e, k, 0.001, 0.01, 1)
    lv, r0, r1 = run_sgd(Graph(e), k=k, step=0.01, iterations=1)
    np.testing.assert_allclose(lv, lv_o, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose([r0, r1], [r0_o, r1_o], rtol=1e-5)


@pytest.mark.parametrize("k", WIDTHS)
def test_lda_step_matches_oracle(k):
    ndoc, nterms = 7, 11
    e = bipartite_edges(ndoc, nterms, seed=k)
    expect = lda_oracle(e, ndoc, nterms, k, iters=1)
    N, _gn, ll = run_lda(Graph(e), ndoc, nterms, k=k, iterations=1)
    np.testing.assert_allclose(N, expect, rtol=2e-4, atol=2e-4)
    assert np.isfinite(ll)
