"""The persistent XLA compilation cache of the measurement scripts."""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache`` — a fixed path (the cache key includes
    it), computed from the package's location."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.
    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here; otherwise the cache lives in
    ``default_cache_dir()``."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
