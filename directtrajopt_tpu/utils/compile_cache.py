"""Persistent compilation cache for the entry scripts.

The cache is keyed by its path among other things, so it must sit at a path
that does not move: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets
it (JAX reads that variable itself), otherwise ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os

import jax

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env:
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return env or REPO_CACHE_DIR
