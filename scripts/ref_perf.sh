#!/bin/bash
# Reference-on-host performance protocol (PERF.md rounds 4c/5a/5i):
# build GraphMat v2.0 from /root/reference at -O3 with the single-rank
# stub, export the EXACT bench inputs (same seeds as bench.py) in the
# reference's binary mtx format, and run each app with 2 OpenMP
# threads.  Ratios in PERF.md round 5i come from these commands on an
# otherwise-idle host.
set -e
REF=${REF:-/root/reference}
OUT=${OUT:-/tmp/refbuild}
STUB=$(cd "$(dirname "$0")/ref_stub" && pwd)
REPO=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$OUT/bin" "$OUT/data"

for app in PageRank BFS SSSP SGD LDA TriangleCounting; do
  g++ -O3 -march=native -fopenmp -std=c++11 -w \
      -include "$STUB/gm_compat.h" -I "$STUB" \
      -I $REF/include -I $REF/include/GMDP \
      $REF/src/$app.cpp -o $OUT/bin/$app
  echo "built $app"
done

python - <<PY
import jax; jax.config.update('jax_platforms','cpu')
import numpy as np, os, sys
sys.path.insert(0, "$REPO")
from graphmat.utils.generators import rmat_edgelist
from graphmat.io.edgelist import EdgeList, write_edgelist

def link(p):
    if not os.path.exists(p + "0"):
        os.symlink(p, p + "0")   # ReadMTX wants per-rank suffixes

e = rmat_edgelist(20, 16, seed=1)                     # bench graph
p = "$OUT/data/rmat20.bin.mtx"
write_edgelist(e, p, binaryformat=True); link(p)

rng = np.random.default_rng(3)                        # bench_sssp weights
w = rng.integers(1, 256, len(e.src)).astype(np.int32)
p = "$OUT/data/rmat20w.bin.mtx"
write_edgelist(EdgeList(src=e.src, dst=e.dst, val=w, m=e.m, n=e.n),
               p, binaryformat=True); link(p)

rng = np.random.default_rng(0)                        # bench_sgd ratings
nu, ni, nr = 60000, 20000, 1_000_000
us = rng.integers(1, nu + 1, nr).astype(np.int64)
it = (nu + rng.integers(1, ni + 1, nr)).astype(np.int64)
val = rng.integers(1, 6, nr).astype(np.int32)
p = "$OUT/data/ratings1m.bin.mtx"
write_edgelist(EdgeList(src=us, dst=it, val=val, m=nu+ni, n=nu+ni),
               p, binaryformat=True); link(p)

rng = np.random.default_rng(11)                       # bench_lda docterm
ndoc, nterms, ntok = 30000, 10000, 1_000_000
docs = rng.integers(1, ndoc + 1, ntok).astype(np.int64)
terms = (ndoc + rng.integers(1, nterms + 1, ntok)).astype(np.int64)
cnt = np.minimum(rng.zipf(2.0, ntok), 50).astype(np.int32)
p = "$OUT/data/docterm1m.bin.mtx"
write_edgelist(EdgeList(src=docs, dst=terms, val=cnt,
                        m=ndoc+nterms, n=ndoc+nterms),
               p, binaryformat=True); link(p)
print("bench inputs exported")
PY

cd "$OUT"; export OMP_NUM_THREADS=${OMP_NUM_THREADS:-2}
echo "== PageRank (prints per-run total; iters in output)"
./bin/PageRank data/rmat20.bin.mtx | grep -E "Time|iterations"
echo "== BFS x3 sources"
for s in 5 123 77777; do ./bin/BFS data/rmat20.bin.mtx $s | grep -E "Time|Reachable"; done
echo "== SSSP"
./bin/SSSP data/rmat20w.bin.mtx 1 | grep -E "Time|Reachable"
echo "== SGD (10 iters, K=20; init RMSE must print 2.638534)"
./bin/SGD data/ratings1m.bin.mtx | grep -E "Time|RMSE"
echo "== LDA (30 iters, K=20)"
./bin/LDA data/docterm1m.bin.mtx 30000 10000 30 | grep -E "Time|likelihood"
