"""Per-phase timing & counters.

The reference gates ``gettimeofday`` phase prints behind ``-D__TIMING``
(``Makefile:37-40``, ``GraphMatRuntime.h:125-248``) with the taxonomy:
send_message / SPMV / apply / do_every_iteration / per-iteration summary.
Our engine compiles the whole iteration into one XLA program, so phases
aren't host-observable per iteration; instead we provide:

* :class:`PhaseTimer` — host-side wall-clock phases for the coarse stages
  (graph build, compile, run) plus derived rates (edges/s);
* ``profile_trace`` — a context manager around ``jax.profiler.trace`` for
  the real per-op timeline when deep-diving.

Enable with env ``GRAPHMAT_TIMING=1`` (the ``timing=1`` make-var
analog) or explicitly.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["PhaseTimer", "timing_enabled", "profile_trace"]


def timing_enabled() -> bool:
    return os.environ.get("GRAPHMAT_TIMING", "0") not in ("0", "", "false")


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase; prints a GraphMat-style
    summary."""

    enabled: bool = True
    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def rate(self, name: str, units: float) -> float:
        """units per second for a phase (e.g. edges processed)."""
        t = self.totals.get(name, 0.0)
        return units / t if t > 0 else float("inf")

    def summary(self) -> str:
        lines = []
        for name, t in sorted(self.totals.items()):
            lines.append(f"{name} time = {t * 1e3:.3f} ms "
                         f"(n={self.counts[name]})")
        return "\n".join(lines)

    def report(self) -> None:
        if self.enabled:
            print(self.summary())


@contextlib.contextmanager
def profile_trace(logdir: str = "/tmp/graphmat_trace"):
    """jax.profiler trace for op-level timelines (view with XProf)."""
    import jax
    with jax.profiler.trace(logdir):
        yield
