"""Persistent compilation cache location for the entry-point scripts."""
from __future__ import annotations

import os

import jax

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache where
    `JAX_COMPILATION_CACHE_DIR` says (JAX reads the variable itself, so
    nothing is set then), else in `<checkout>/.jax_cache`. Call before the
    first compile; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
