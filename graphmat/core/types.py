"""Core enums and semiring building blocks.

The reference expresses a semiring as two C++ virtuals — ``process_message``
(⊗) and ``reduce_function`` (⊕) — dispatched per edge through function
pointers (``include/GraphProgram.h:38-101``, ``include/SPMV.h:41-59``).  On
an accelerator the ⊕ must be a vectorizable associative reduction, so we reify it as a
:class:`Monoid` that knows its identity and how to lower to an XLA segment
reduction.  Named monoids (sum/min/max/or) hit ``jax.ops.segment_*`` fast
paths; arbitrary user combines fall back to a segmented associative scan
(see ``graphmat.ops.segment``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

__all__ = [
    "Direction",
    "Activity",
    "Monoid",
    "SUM",
    "MIN",
    "MAX",
    "ANY",
    "LOR",
    "UNTIL_CONVERGENCE",
]

UNTIL_CONVERGENCE = -1  # reference: GraphMatRuntime.h:51


class Direction(enum.Enum):
    """Which edges a vertex program runs over (``GraphProgram.h:34``).

    Semantics (matching the reference's ``SpMTSpV``/``SpMSpV`` dispatch,
    ``GraphMatRuntime.h:160-176``):

    * ``OUT_EDGES``: messages travel along edge direction — sender = src,
      receiver = dst.
    * ``IN_EDGES``: messages travel against edge direction — sender = dst,
      receiver = src.
    * ``ALL_EDGES``: both, reduced into the same result.
    """

    OUT_EDGES = "out"
    IN_EDGES = "in"
    ALL_EDGES = "all"


class Activity(enum.Enum):
    """Whether all vertices or only active ones send each iteration
    (``GraphProgram.h:36``)."""

    ACTIVE_ONLY = "active_only"
    ALL_VERTICES = "all_vertices"


def _min_identity(dtype):
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(jnp.inf, dtype)
    return jnp.array(jnp.iinfo(dtype).max, dtype)


def _max_identity(dtype):
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(-jnp.inf, dtype)
    return jnp.array(jnp.iinfo(dtype).min, dtype)


@dataclass(frozen=True)
class Monoid:
    """An associative reduction with identity.

    ``kind`` selects an XLA fast path: one of ``'sum' | 'min' | 'max' | 'or'``.
    ``kind='generic'`` uses ``combine_fn`` (an arbitrary associative binary
    elementwise function) via segmented scan — slower but fully general,
    the analog of the reference's arbitrary ``reduce_function``.

    ``'any'`` (pick one message, unspecified which — the reference's
    overwrite-reduce, e.g. BFS parent selection, ``src/BFS.cpp:74-76``) is
    implemented deterministically as ``min``.
    """

    kind: str = "sum"
    combine_fn: Optional[Callable] = None
    identity_fn: Optional[Callable] = None  # dtype -> scalar, for generic

    def identity(self, dtype):
        if self.kind == "sum":
            return jnp.array(0, dtype)
        if self.kind in ("min", "any"):
            return _min_identity(dtype)
        if self.kind == "max":
            return _max_identity(dtype)
        if self.kind == "or":
            return jnp.array(False, jnp.bool_)
        if self.kind == "generic":
            if self.identity_fn is None:
                raise ValueError("generic Monoid needs identity_fn")
            return jnp.asarray(self.identity_fn(dtype), dtype)
        raise ValueError(f"unknown monoid kind {self.kind}")

    def combine(self, a, b):
        if self.kind == "sum":
            return a + b
        if self.kind in ("min", "any"):
            return jnp.minimum(a, b)
        if self.kind == "max":
            return jnp.maximum(a, b)
        if self.kind == "or":
            return jnp.logical_or(a, b)
        if self.kind == "generic":
            return self.combine_fn(a, b)
        raise ValueError(f"unknown monoid kind {self.kind}")


SUM = Monoid("sum")
MIN = Monoid("min")
MAX = Monoid("max")
ANY = Monoid("any")  # overwrite-reduce; deterministic min tie-break
LOR = Monoid("or")


def np_identity(monoid: Monoid, dtype) -> np.ndarray:
    """Numpy-side identity for host preprocessing."""
    return np.asarray(monoid.identity(dtype))
