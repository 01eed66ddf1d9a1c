"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins untouched;
otherwise the cache goes to the fixed ``<repo>/.jax_cache``."""

import os

import jax
import pytest

from graphmat.utils.compile_cache import (DEFAULT_CACHE_DIR,
                                          enable_compile_cache)


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_is_left_to_jax(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_fixed_repo_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == DEFAULT_CACHE_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
