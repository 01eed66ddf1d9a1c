"""``chip_smoke.py``'s phases at tiny sizes on the CPU (each compares the
engine with its numpy/scipy reference), its refusal to run without a GPU,
and — on a card only — the phases at a mid size."""

import jax
import pytest

import chip_smoke as cs

PHASE_RECORD = ("phase", "wall_s", "compile_s", "cache_hits",
                "peak_bytes_in_use")


@pytest.fixture(scope="module")
def rmat():
    e = cs.rmat_graph(9)
    return e, cs.Graph(e)


def _recorded(rec, phase):
    assert rec["phase"] == phase
    assert all(k in rec for k in PHASE_RECORD)
    return rec


def test_pagerank_phase(rmat):
    rec = _recorded(cs.phase_pagerank(*rmat), "pagerank")
    assert rec["iters"] > 1


def test_bfs_phase(rmat):
    e, g = rmat
    rec = _recorded(cs.phase_bfs(e, g, cs._roots(e, 3, seed=1)), "bfs")
    assert len(rec["iters"]) == 3 and min(rec["reached"]) > 1


def test_sssp_phase(rmat):
    e, g = rmat
    rec = _recorded(cs.phase_sssp(e, g, cs._roots(e, 1, seed=2)[0]), "sssp")
    assert rec["reached"] > 1


def test_sgd_phase():
    el = cs.ratings(300, 100, 3000)
    rec = _recorded(cs.phase_sgd(el, cs.Graph(el), k=20, iters=3), "sgd")
    assert rec["rmse_final"] < rec["rmse_init"]


def test_lda_phase():
    rec = _recorded(cs.phase_lda(cs.doc_terms(200, 50, 3000), 200, 50,
                                 k=20, iters=2), "lda")
    assert rec["loglik"] < 0


def test_tc_phase():
    rec = _recorded(cs.phase_tc(scale=10, ref_scale=8), "tc")
    assert rec["triangles"] > 0 and rec["triangles_small"] > 0


def test_four_device_phases():
    recs = list(cs.four_gpu_phases(scale=9, sgd=(300, 100, 3000)))
    assert [r["phase"] for r in recs] == ["pagerank", "bfs", "sgd"]
    assert recs[0]["mesh"] == [2, 2]


@pytest.mark.parametrize("argv", [[], ["--four-gpus"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert jax.devices()[0].platform != "gpu"
    assert cs.main(argv) == 2
    out, err = capsys.readouterr()
    assert '"ok"' not in out and "no GPU" in err


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")


@pytest.mark.chip
def test_phases_on_gpu(gpu):
    recs = list(cs.single_gpu_phases(scale=16, tc_scale=16, tc_ref_scale=12,
                                     sgd=(6000, 2000, 100_000),
                                     lda=(3000, 1000, 100_000)))
    assert [r["phase"] for r in recs] == ["pagerank", "bfs", "sssp", "sgd",
                                          "lda", "tc"]
    assert all(r["peak_bytes_in_use"] for r in recs)
