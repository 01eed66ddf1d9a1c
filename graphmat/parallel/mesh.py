"""Device mesh helpers for the 2D-sharded graph engine.

The reference distributes the adjacency over an ``nrank × nrank``
block-cyclic tile grid (``GMDP/matrices/layouts.h:39-57``,
``SpMat.h:280-321``) with hand-rolled MPI.  Here the analog is a named 2D
``jax.sharding.Mesh`` with axes ``('r', 'c')``:

* tile (i, j) of the adjacency lives on device (i, j);
* the frontier/vertex vectors are sharded over the flattened mesh
  (vertex segment (i, j) on device (i, j));
* the per-iteration column-broadcast becomes ``all_gather`` along ``'r'``
  and the row-reduction becomes ``psum_scatter``/``all_to_all`` along
  ``'c'``, XLA collectives (NCCL on GPUs) instead of point-to-point sends.

Within one host every GPU reaches every other over NVLink at the same
rate, so the mesh shape follows the algorithm (``factor2d``), not the
wiring.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "vector_sharding", "tile_sharding", "factor2d"]

ROW_AXIS = "r"
COL_AXIS = "c"


def factor2d(n: int) -> tuple:
    """Split n devices into the most-square (R, C) grid — the analog of
    ``factorize_int`` in ``layouts.h:39-49``."""
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def make_mesh(devices=None, shape: tuple | None = None) -> Mesh:
    """Build an ('r', 'c') mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = factor2d(len(devices))
    r, c = shape
    dev = np.asarray(devices[: r * c]).reshape(r, c)
    return Mesh(dev, (ROW_AXIS, COL_AXIS))


def vector_sharding(mesh: Mesh) -> NamedSharding:
    """Vertex vectors: leading axis split over the flattened (r, c) mesh —
    segment (i, j) on device (i, j)."""
    return NamedSharding(mesh, P((ROW_AXIS, COL_AXIS)))


def tile_sharding(mesh: Mesh) -> NamedSharding:
    """Stacked per-tile arrays [R*C, ...]: axis 0 over the flattened mesh —
    tile (i, j) on device (i, j)."""
    return NamedSharding(mesh, P((ROW_AXIS, COL_AXIS)))
