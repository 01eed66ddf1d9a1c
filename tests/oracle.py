"""Pure-python/numpy oracle implementation of GraphMat's run_graph_program.

A deliberately naive per-edge interpreter of the reference semantics
(``include/GraphMatRuntime.h:94-279``), independent of the JAX engine's
vectorized code paths.  Tests compare the engine's results against this.

The oracle program is a plain object with scalar (per-element) callbacks,
mirroring the reference's C++ virtuals:

* ``send(vp_dict_i) -> (msg, bool)``
* ``process(msg, edge_val, vp_recv_dict) -> u``
* ``combine(u1, u2) -> u``
* ``apply(u, vp_dict_i) -> new vp_dict_i``
* ``changed(old_i, new_i) -> bool``
* ``order`` in {'out', 'in', 'all'}, ``activity`` in {'active', 'all'}
* optional ``every_iter(oracle_state)`` hook
"""

from __future__ import annotations

import numpy as np


class OracleGraph:
    def __init__(self, edgelist, vp_init: dict):
        self.n = max(edgelist.m, edgelist.n)
        self.src = edgelist.src - 1
        self.dst = edgelist.dst - 1
        self.val = edgelist.val
        # vp: list of per-vertex dicts
        self.vp = [{k: (v[i] if hasattr(v, "__len__") and np.ndim(v) >= 1
                        and len(v) == self.n else v)
                    for k, v in vp_init.items()} for i in range(self.n)]
        self.vp = [dict(d) for d in self.vp]
        self.active = np.zeros(self.n, bool)


def oracle_run(g: OracleGraph, prog, iterations=-1, max_iterations=10000):
    it = 0
    if getattr(prog, "activity", "active") == "all":
        g.active[:] = True
    while True:
        msgs = {}
        for i in range(g.n):
            if not g.active[i]:
                continue
            m, ok = prog.send(g.vp[i])
            if ok:
                msgs[i] = m

        y = {}
        directions = {"out": [(g.src, g.dst)], "in": [(g.dst, g.src)],
                      "all": [(g.src, g.dst), (g.dst, g.src)]}[prog.order]
        for senders, receivers in directions:
            for e in range(len(senders)):
                s, r = int(senders[e]), int(receivers[e])
                if s not in msgs:
                    continue
                u = prog.process(msgs[s], g.val[e], g.vp[r])
                y[r] = prog.combine(y[r], u) if r in y else u

        g.active[:] = False
        converged = True
        for r, u in y.items():
            old = dict(g.vp[r])
            g.vp[r] = prog.apply(u, dict(g.vp[r]))
            if prog.changed(old, g.vp[r]):
                g.active[r] = True
                converged = False

        if hasattr(prog, "every_iter"):
            prog.every_iter(g, it)

        if getattr(prog, "activity", "active") == "all":
            g.active[:] = True
        it += 1
        if iterations > 0 and it == iterations:
            break
        if iterations <= 0 and converged:
            break
        if it >= max_iterations:
            raise RuntimeError("oracle did not converge")
    return it


def vp_array(g: OracleGraph, field: str) -> np.ndarray:
    return np.array([g.vp[i][field] for i in range(g.n)])
