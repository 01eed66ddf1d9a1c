"""Structured logging & counters.

The reference prints unstructured progress from every MPI rank
(``SpMat.h:107``, ``DCSCTile.h:130`` ...).  Here: a standard-library logger
that only emits on host 0 (``jax.process_index() == 0``), plus lightweight
counter helpers for the metrics the reference tracks per iteration
(frontier nnz, updated vertices, edges processed).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict

__all__ = ["get_logger", "Counters", "log_iteration"]

_LOGGER = None


def _is_host0() -> bool:
    try:
        import jax
        return jax.process_index() == 0
    except Exception:
        return True


def get_logger(name: str = "graphmat") -> logging.Logger:
    """Host-0-only logger; level via env GRAPHMAT_LOG (default INFO)."""
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    level = os.environ.get("GRAPHMAT_LOG", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    if not _is_host0():
        logger.setLevel(logging.CRITICAL)
    logger.propagate = False
    _LOGGER = logger
    return logger


class Counters:
    """Accumulating named counters (edges processed, frontier sizes, ...)."""

    def __init__(self):
        self.values: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    def add(self, name: str, amount: float = 1.0) -> None:
        self.values[name] = self.values.get(name, 0.0) + amount

    def rate(self, name: str) -> float:
        dt = time.perf_counter() - self._t0
        return self.values.get(name, 0.0) / dt if dt > 0 else 0.0

    def summary(self) -> str:
        parts = [f"{k}={v:.6g}" for k, v in sorted(self.values.items())]
        return " ".join(parts)


def log_iteration(it: int, nupdated: int | None = None,
                  nactive: int | None = None, ms: float | None = None):
    """The reference's per-iteration line (``GraphMatRuntime.h:246-248``)."""
    msg = f"Iteration {it}"
    if ms is not None:
        msg += f" :: {ms:.3f} msec"
    if nupdated is not None:
        msg += f" :: updated {nupdated} vertices"
    if nactive is not None:
        msg += f" :: changed {nactive} vertices"
    get_logger().info(msg)
