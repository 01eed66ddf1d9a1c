"""Persistent XLA compile cache for the command-line entry points.

``chip_smoke.py``, ``bench.py`` and the app CLIs call
:func:`enable_compile_cache` once at start-up; importing the library sets
nothing.  JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when that
variable is set the helper leaves the configuration alone.  Otherwise the
cache lives at ``<repo>/.jax_cache`` — a fixed path, because the directory
is part of what a later run must find again.
"""

from __future__ import annotations

import os

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    # JAX writes entries into the directory without creating it first
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
