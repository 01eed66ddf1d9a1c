"""Device-time breakdown of PageRank's XLA step on the GPU.

Builds the Graph500 RMAT graph (scale 22, edgefactor 16 by default), runs
PageRank once to compile and warm up, times ``--iters`` fixed iterations
end to end, then traces the same window with ``jax.profiler`` and sums
each XLA op's device time.  Prints one JSON line per op (device ms per
iteration, share of the window), then a summary line (ms/iter end to end,
GTEPS, busy share of the traced window).  The raw trace and the compiled
HLO text go under ``--out``.

    python scripts/profile_pagerank.py [--scale 22] [--iters 20] \
        [--out chiprun_out/pagerank_profile]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def device_op_times(xplane_path):
    """{op name: (total ns, count)} over the GPU planes' XLA-op lines,
    plus the traced window and the union of busy intervals (ns)."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane_path)
    ops = collections.defaultdict(lambda: [0, 0])
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        names = [ln.name for ln in lines]
        pick = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if "Stream" in ln.name]
        print(json.dumps({"plane": plane.name, "lines": names}))
        for ln in pick:
            for ev in ln.events:
                ops[ev.name][0] += ev.duration_ns
                ops[ev.name][1] += 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    return dict(ops), window, busy


def _progress(msg, t0=time.perf_counter()):
    print(f"[{time.perf_counter() - t0:8.1f}s] {msg}", file=sys.stderr,
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/pagerank_profile")
    args = ap.parse_args()

    import jax

    from graphmat import Graph
    from graphmat.apps.pagerank import PageRankProgram, run_pagerank
    from graphmat.core.runtime import Engine
    from graphmat.utils.compile_cache import enable_compile_cache
    from graphmat.utils.generators import rmat_edgelist
    enable_compile_cache()

    e = rmat_edgelist(args.scale, args.edgefactor, seed=1)
    g = Graph(e)
    _progress("graph built")
    _pr, niter = run_pagerank(g)          # degrees + a converged PR state
    _progress(f"pagerank converged in {niter} iterations")
    eng = Engine(PageRankProgram(), g)
    state0 = dict(g.vp)
    eng.run(iterations=args.iters)        # compile + warm
    _progress("fixed-iteration run compiled")
    os.makedirs(args.out, exist_ok=True)
    hlo = eng._run_fixed.lower(eng._structure(), (), state0, g.active,
                               args.iters).compile().as_text()
    with open(os.path.join(args.out, "pagerank_hlo.txt"), "w") as f:
        f.write(hlo)

    times = []
    for _ in range(5):
        g.vp = dict(state0)
        jax.block_until_ready(g.vp)
        t0 = time.perf_counter()
        eng.run(iterations=args.iters)
        times.append(time.perf_counter() - t0)
    _progress("timed")
    g.vp = dict(state0)
    jax.block_until_ready(g.vp)
    with jax.profiler.trace(args.out):
        eng.run(iterations=args.iters)
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    _progress("traced")
    ops, window, busy = device_op_times(path)
    for name, (ns, cnt) in sorted(ops.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps({"op": name, "count": cnt,
                          "ms_per_iter": ns / 1e6 / args.iters,
                          "share_of_window": ns / window if window else None}))
    med = sorted(times)[len(times) // 2]
    print(json.dumps({
        "graph": f"rmat{args.scale}x{args.edgefactor}", "nnz": int(g.nnz),
        "n": int(g.n), "iters": args.iters,
        "runs_s": times, "ms_per_iter": med / args.iters * 1e3,
        "gteps": g.nnz * args.iters / med / 1e9,
        "traced_window_ms": window / 1e6, "device_busy_ms": busy / 1e6,
        "busy_share": busy / window if window else None,
        "converged_iters": niter,
        "device_kind": jax.devices()[0].device_kind}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
